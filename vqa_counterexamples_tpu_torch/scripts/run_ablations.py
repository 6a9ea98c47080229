"""Run the 19-config CX ablation grid (reference ``options/cx/*.yaml``,
``configs/cx/``) end to end through the port's CLI on synthetic data and
write the table (port of the JAX package's ``scripts/run_ablations.py``,
with its protocol: 3 epochs, batch 256, 2,048 synthetic train examples,
seed 42, lr from each config).  Per row the command is::

    python -m vqa_counterexamples_tpu_torch.cli.counterexamples \\
        --cx_model NeuralModel --path_opt configs/cx/<config>.yaml \\
        --epochs 3 --synthetic 2048 --batch_size 256 --seed 42 \\
        --project_dir <project_dir> --device <device>

As in JAX's, the YAML's ``cx_model.trainable_vqa`` is overridden by the
CLI's (absent) ``--trainable_vqa`` flag, so every row trains over a frozen
backbone.  Usage::

    python -m vqa_counterexamples_tpu_torch.scripts.run_ablations \\
        [--configs a,b,...] [--jobs N] [--device cpu]

prints one JSON line per config (``config``, ``rc``, ``wall_s``, the last
epoch's val ``loss`` / ``recall5`` / ``recall1``, or the output's tail)
and writes the markdown table to ``--out``.  ``--configs`` takes config
names or YAML paths; ``--jobs`` runs that many CLIs at once (one card
holds several).
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--configs", type=str, default=None,
                        help="comma-separated config names or YAML paths "
                             "(default: all of configs/cx)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--synthetic", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--jobs", type=int, default=1,
                        help="CLIs run at once")
    parser.add_argument("--project_dir", type=str,
                        default=os.path.join("logs", "ablations"))
    parser.add_argument("--out", type=str, default=None,
                        help="markdown table (default: "
                             "<project_dir>/ablations_rows.md)")
    parser.add_argument("--timeout", type=float, default=3600.0,
                        help="seconds a config may run")
    return parser


def config_paths(spec: str | None) -> list:
    """The YAMLs of ``--configs``: names under ``configs/cx`` or paths."""
    if not spec:
        return sorted(glob.glob(os.path.join(REPO, "configs", "cx",
                                             "*.yaml")))
    return [os.path.abspath(c) if c.endswith(".yaml")
            else os.path.join(REPO, "configs", "cx", c + ".yaml")
            for c in spec.split(",")]


def command(cfg_path: str, args) -> list:
    """The CLI's command line for one config (seed 42, the protocol's)."""
    return [sys.executable, "-m",
            "vqa_counterexamples_tpu_torch.cli.counterexamples",
            "--cx_model", "NeuralModel", "--path_opt", cfg_path,
            "--epochs", str(args.epochs), "--synthetic", str(args.synthetic),
            "--batch_size", str(args.batch_size), "--seed", "42",
            "--project_dir", args.project_dir, "--device", args.device]


def parse_row(name: str, rc: int, wall_s: float, out: str,
              err: str) -> dict:
    """The row of one run: the last ``Epoch N val: {...}`` line's metrics
    (the CLI prints that dict; ``nan`` / ``inf`` where a config
    diverges)."""
    row = {"config": name, "rc": rc, "wall_s": round(wall_s, 1)}
    matches = re.findall(r"Epoch \d+ val: ({.*})", out)
    if matches:
        vals = eval(matches[-1],  # noqa: S307 (the CLI's own dict)
                    {"__builtins__": {}, "nan": float("nan"),
                     "inf": float("inf")})
        row.update(loss=vals.get("loss", float("nan")),
                   recall5=vals.get("recall", float("nan")),
                   recall1=vals.get("recall_1", float("nan")))
    else:
        row["tail"] = (err or out)[-800:]
    return row


def run_one(cfg_path: str, args) -> dict:
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    start = time.time()
    proc = subprocess.run(command(cfg_path, args), capture_output=True,
                          text=True, cwd=REPO, timeout=args.timeout)
    return parse_row(name, proc.returncode, time.time() - start,
                     proc.stdout, proc.stderr)


def table(rows: list) -> str:
    lines = ["| config | val loss | recall@5 | recall@1 | wall_s |",
             "|---|---|---|---|---|"]
    for r in rows:
        if r["rc"] == 0 and "loss" in r:
            lines.append("| %s | %.4f | %.4f | %.4f | %.1f |"
                         % (r["config"], r["loss"], r["recall5"],
                            r["recall1"], r["wall_s"]))
        else:
            lines.append("| %s | FAILED rc=%d | | | %.1f |"
                         % (r["config"], r["rc"], r["wall_s"]))
    return "\n".join(lines) + "\n"


def ok(row: dict) -> bool:
    """rc 0 and a finite val loss."""
    return row["rc"] == 0 and math.isfinite(row.get("loss", float("nan")))


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    args.project_dir = os.path.abspath(args.project_dir)
    cfgs = config_paths(args.configs)
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        rows = []
        for row in pool.map(lambda c: run_one(c, args), cfgs):
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = args.out or os.path.join(args.project_dir, "ablations_rows.md")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(table(rows))
    print("table written to %s" % out, flush=True)
    return rows


if __name__ == "__main__":
    rows = main()
    sys.exit(0 if all(ok(r) for r in rows) else 1)
