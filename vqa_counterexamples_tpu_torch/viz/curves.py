"""Training-curve dashboards (port of ``viz/curves.py``; reference
``visu.py``).

Builds single- or multi-experiment HTML dashboards from ``logger.json``
(Experiment) files and/or the ``events.jsonl`` scalar streams.  Uses plotly
when importable, else falls back to matplotlib PNGs embedded in HTML — both
produce a self-contained file with loss/acc curves per split plus the
best-val-accuracy trace (the reference's "best val accuracy top1" plot,
doc/mutan_noatt.html).
"""

from __future__ import annotations

import base64
import io
import json
import os


def load_curves(dir_logs: str) -> dict:
    """{'<split>/<meter>': (xs, ys)} from logger.json (``core/experiment.
    Experiment.to_json``: its ``logged`` meters by split, keyed by epoch)
    and/or the ``events.jsonl`` scalar streams (``ScalarWriter``)."""
    curves = {}
    logger_path = os.path.join(dir_logs, "logger.json")
    if os.path.isfile(logger_path):
        with open(logger_path) as f:
            logged = json.load(f)["logged"]
        for split, meters in logged.items():
            for meter, by_epoch in meters.items():
                pts = sorted((int(k), v) for k, v in by_epoch.items())
                curves["%s/%s" % (split, meter)] = (
                    [p[0] for p in pts], [p[1] for p in pts])
    # per-epoch OpenEnded accuracy files written by cli/eval_res.py
    # (the reference visu.py reads the same artifacts, visu.py:45-105)
    import glob
    import re
    oe = []
    for path in glob.glob(os.path.join(dir_logs, "results", "*",
                                       "*_epoch_*_accuracy.json")):
        m = re.search(r"_epoch_(\d+)_accuracy\.json$", path)
        if m:
            with open(path) as f:
                oe.append((int(m.group(1)), json.load(f)["overall"]))
    if oe:
        oe.sort()
        curves["val/openended"] = ([e for e, _ in oe], [v for _, v in oe])

    for sub in ("", "train", "val"):
        ev = os.path.join(dir_logs, sub, "events.jsonl")
        if os.path.isfile(ev):
            series: dict = {}
            with open(ev) as f:
                for line in f:
                    rec = json.loads(line)
                    series.setdefault(rec["tag"], []).append(
                        (rec["step"], rec["value"]))
            for tag, pts in series.items():
                key = "%s/%s" % (sub or "events", tag)
                pts.sort()
                curves[key] = ([p[0] for p in pts], [p[1] for p in pts])
    return curves


def best_trace(xs, ys, maximize=True):
    best, out = None, []
    for y in ys:
        best = y if best is None else (max(best, y) if maximize
                                       else min(best, y))
        out.append(best)
    return out


def render_html(experiments: dict, out_path: str,
                meters=("loss", "acc1", "acc5", "recall")) -> str:
    """experiments: {name: curves-dict}.  Writes an HTML dashboard."""
    try:
        return _render_plotly(experiments, out_path, meters)
    except ImportError:
        return _render_matplotlib(experiments, out_path, meters)


def _select(curves, meter):
    return {key: xy for key, xy in curves.items()
            if key.split("/")[-1] == meter}


def _render_plotly(experiments, out_path, meters):
    import plotly.graph_objects as go
    from plotly.offline import plot

    figs = []
    for meter in meters:
        fig = go.Figure()
        found = False
        for name, curves in experiments.items():
            for key, (xs, ys) in _select(curves, meter).items():
                found = True
                fig.add_trace(go.Scatter(x=xs, y=ys, mode="lines",
                                         name="%s %s" % (name, key)))
                if meter.startswith("acc") or meter == "recall":
                    fig.add_trace(go.Scatter(
                        x=xs, y=best_trace(xs, ys), mode="lines",
                        line=dict(dash="dash"),
                        name="best %s: %s" % (key, name)))
        if found:
            fig.update_layout(title=meter, xaxis_title="epoch")
            figs.append(plot(fig, output_type="div", include_plotlyjs=False))
    html = ("<html><head><script src='https://cdn.plot.ly/plotly-latest.min"
            ".js'></script></head><body>%s</body></html>" % "\n".join(figs))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def _render_matplotlib(experiments, out_path, meters):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs = []
    for meter in meters:
        fig, ax = plt.subplots(figsize=(7, 4))
        found = False
        for name, curves in experiments.items():
            for key, (xs, ys) in _select(curves, meter).items():
                found = True
                ax.plot(xs, ys, label="%s %s" % (name, key))
                if meter.startswith("acc") or meter == "recall":
                    ax.plot(xs, best_trace(xs, ys), "--",
                            label="best %s: %s" % (key, name))
        if not found:
            plt.close(fig)
            continue
        ax.set_title(meter)
        ax.set_xlabel("epoch")
        ax.legend(fontsize=7)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=80, bbox_inches="tight")
        plt.close(fig)
        imgs.append('<img src="data:image/png;base64,%s">'
                    % base64.b64encode(buf.getvalue()).decode())
    with open(out_path, "w") as f:
        f.write("<html><body>%s</body></html>" % "\n".join(imgs))
    return out_path
