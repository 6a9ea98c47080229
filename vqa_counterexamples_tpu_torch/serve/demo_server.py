"""VQA demo HTTP server (port of the JAX package's ``serve/demo_server.py``;
reference ``demo_server.py``).

POST ``/`` with JSON ``{"visual": <base64 jpeg>, "question": "..."}`` returns
``{"ans": [top-5 answers], "val": [probs], "att": [b64 PNG glimpse maps]}``
with CORS headers: the reference's contract (demo_server.py:44-125), so the
bundled web client (``serve/demo_web``) works unchanged.  Beyond it:

* ``POST /batch``: ``{"items": [{"visual", "question"}, ...]}`` runs every
  item in ONE forward (images stacked, padded to a power-of-two bucket) and
  returns ``{"results": [...]}`` in order.
* ``GET /checkpoints`` + ``POST /checkpoint {"name": ...}``: list / hot-swap
  VQA checkpoints under ``--ckpt_root`` (the ``ckpt_model.msgpack`` /
  ``best_model.msgpack`` layout of either package, ``core/checkpoint.py``)
  without restarting.
* ``GET /health``, and the web client with ``--serve_web``.

The forward (:meth:`DemoEngine.predict_prepared`) is the JAX server's
``predict``: uint8 images normalized on the card, the ResNet trunk
(``models/convnets``), then an attention arch (MutanAtt, MLBAtt) on the
(B, 14, 14, 2048) maps with ``return_att``, or a no-attention one
(MutanNoAtt, MLBNoAtt) on their spatial mean, as the YAML's arch names it;
a softmax and the top 5.  On the card each power-of-two bucket is one
captured CUDA graph (``core/graphs.GraphedCall``), as JAX compiles one
program per bucket; its kernels are the GRU forward, and MUTAN and, with
MutanAtt, the folded MUTAN forward (under the bf16 policy,
``VQACX_COMPUTE_DTYPE=bfloat16``); the MLB archs run the GRU forward
only.  A
checkpoint swap copies the weights into the captured tensors in place
while no bucket is replaying, and captures nothing anew.  The device is
``cuda``; with no card visible the server refuses to start unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

MAX_BATCH = 32


def _next_bucket(n: int, max_batch: int = MAX_BATCH) -> int:
    """Smallest power-of-two >= n (capped): at most log2 graphs."""
    b = 1
    while b < min(n, max_batch):
        b *= 2
    return b


def list_checkpoints(root: str) -> list[dict]:
    """Scan ``root`` for loadable VQA checkpoints.

    A run directory counts if it holds a ``best_model.msgpack`` or
    ``ckpt_model.msgpack`` (``core/checkpoint.save_vqa_checkpoint``'s layout;
    best_* files live NEXT TO ckpt_*, the reference's prefix scheme).
    Returns ``[{"name", "path", "best", "epoch"}]`` sorted by name;
    ``path`` is a ``load_vqa_model`` prefix (``<run>/best`` for the best
    files)."""
    out = []
    if not root or not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        run_dir = os.path.join(root, name)
        if not os.path.isdir(run_dir):
            continue
        for fname, info_name, is_best in (
                ("best_model.msgpack", "best_info.json", True),
                ("ckpt_model.msgpack", "ckpt_info.json", False)):
            if os.path.isfile(os.path.join(run_dir, fname)):
                epoch = None
                info_path = os.path.join(run_dir, info_name)
                if os.path.isfile(info_path):
                    try:
                        with open(info_path) as f:
                            epoch = json.load(f).get("epoch")
                    except (OSError, ValueError, AttributeError):
                        pass   # listing is best-effort
                path = os.path.join(run_dir, "best") if is_best else run_dir
                out.append({"name": name, "path": path, "best": is_best,
                            "epoch": epoch})
                break
    return out


def glimpse_png(att_map: np.ndarray) -> bytes:
    """One glimpse's (W*H,) weights -> the 112 x 112 grey PNG the web
    client shows (the map scaled to its maximum, nearest-upscaled)."""
    from PIL import Image

    side = int(round(att_map.shape[0] ** 0.5))
    att_map = att_map.reshape(side, side)
    att_map = att_map / max(att_map.max(), 1e-8)
    png = Image.fromarray((att_map * 255).astype("uint8"), "L") \
        .resize((112, 112), resample=0)
    buf = io.BytesIO()
    png.save(buf, format="PNG")
    return buf.getvalue()


class DemoHTTPServer(ThreadingHTTPServer):
    """A thread per request; a listen backlog for a burst of concurrent
    clients (socketserver's default of 5 drops the rest of a burst's
    connection attempts, which the clients retry a second later)."""
    daemon_threads = True
    request_queue_size = 128


class DemoEngine:
    """The serving pipeline over a VQA model and a ResNet trunk (modules
    with their weights, on one device).  ``capture``: None captures one
    CUDA graph per bucket on a card and runs eagerly on the CPU; False runs
    eagerly anywhere."""

    def __init__(self, options, vqa_model, cnn, vocab_words, vocab_answers,
                 attention: bool, *, capture=None):
        from ..core.graphs import GraphedCall
        from ..data.tokenizers import tokenize_mcb
        from ..models import convnets

        self.vocab_answers = list(vocab_answers)
        self.word_to_wid = {w: i + 1 for i, w in enumerate(vocab_words)}
        self.maxlength = options["vqa"].get("maxlength", 26)
        self.pad = options["vqa"].get("pad", "right")
        self.size = options["coco"].get("size", 448)
        self.tokenize = tokenize_mcb
        self.attention = attention
        self.vqa_model = vqa_model.eval()
        self.device = next(vqa_model.parameters()).device
        self.cnn = cnn.to(self.device).eval()
        self._native_dec = None
        self._native_checked = False

        @torch.no_grad()
        def predict(inputs):
            """images (N,H,W,3) uint8, wids (N,T) int -> top-5 + att."""
            images = convnets.normalize_images_device(inputs["images"])
            att_map = self.cnn(images)
            wids = inputs["wids"].long()
            if attention:
                logits, att = self.vqa_model(att_map, wids, return_att=True)
            else:
                visual = att_map.mean(dim=(1, 2))
                logits = self.vqa_model(visual, wids)
                att = torch.zeros((wids.shape[0], 0,
                                   att_map.shape[1] * att_map.shape[2]),
                                  device=att_map.device)
            probs = torch.softmax(logits.float(), dim=-1)
            # equal probabilities rank the lower answer id first, as
            # lax.top_k ranks them (bf16 logits tie often at 2,000
            # answers; topk's order among ties varies with the batch)
            vals, idxs = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
            return {"vals": vals[:, :5], "idxs": idxs[:, :5],
                    "att": att.float()}

        self._predict = GraphedCall(predict, self.device, capture=capture)

    @property
    def n_graphs(self) -> int:
        return self._predict.n_graphs

    def set_params(self, state_dict: dict) -> None:
        """Copy a VQA ``state_dict`` into the model's tensors in place,
        while no bucket runs: every captured graph reads the new weights
        at its next replay, and none is captured again."""
        with self._predict.exclusive():
            self.vqa_model.load_state_dict(state_dict)

    def load_checkpoint(self, path: str) -> None:
        """Hot-swap weights from a checkpoint prefix (``<run>`` for its
        ``ckpt_model.msgpack``, ``<run>/best`` for ``best_model.msgpack``)."""
        from ..core import checkpoint as ckpt_lib

        _, path_model, _ = ckpt_lib.vqa_paths(path)
        if not os.path.isfile(path_model):
            raise FileNotFoundError("no loadable checkpoint under %s" % path)
        self.set_params(ckpt_lib.read_vqa_params(self.vqa_model, path_model))

    def encode_question(self, question: str):
        words = self.tokenize(question)
        wids = [self.word_to_wid.get(w, self.word_to_wid.get("UNK", 1))
                for w in words][:self.maxlength]
        out = np.zeros((self.maxlength,), dtype=np.int32)
        if self.pad == "right":
            out[:len(wids)] = wids
        else:
            out[self.maxlength - len(wids):] = wids
        return out

    def _native_decoder(self):
        if not self._native_checked:
            from ..data.native_decoder import NativeImageDecoder

            dec = NativeImageDecoder()
            self._native_dec = dec if dec.available else None
            self._native_checked = True
        return self._native_dec

    def _decode_raws(self, raws: list) -> np.ndarray:
        """(n, size, size, 3) uint8: one native batch decode (C++ thread
        pool, no GIL), PIL for the items it refuses or for all where the
        library is unavailable."""
        from ..data.native_decoder import decode_buffers

        return decode_buffers(self._native_decoder(), raws, self.size)

    def _decode_image(self, image_b64: str):
        return self._decode_raws(
            [base64.b64decode(image_b64.split(",")[-1])])[0]

    def _att_pngs(self, att) -> list:
        return [base64.b64encode(glimpse_png(att[g])).decode()
                for g in range(att.shape[0])]

    # -- serving pipeline stages (prepare in the request thread, predict as
    # -- one bucketed forward, format back in the request thread) ----------

    def prepare(self, item: dict):
        """Host half of one request: b64 decode + resize + tokenize."""
        return (self._decode_image(item["visual"]),
                self.encode_question(item["question"]))

    def predict_prepared_async(self, images, wids):
        """(n, H, W, 3) uint8 + (n, T) int32 -> (vals, idxs, att) device
        tensors sliced back to n, from ONE forward padded to a power-of-two
        bucket.  The results are the caller's own (copied out of the
        bucket's graph)."""
        n = images.shape[0]
        bucket = _next_bucket(n)
        if bucket > n:  # pad tail rows; results are sliced back to n
            images = np.concatenate(
                [images, np.zeros((bucket - n,) + images.shape[1:],
                                  images.dtype)])
            wids = np.concatenate(
                [wids, np.zeros((bucket - n, wids.shape[1]), wids.dtype)])
        out = self._predict({"images": images, "wids": wids})
        return out["vals"][:n], out["idxs"][:n], out["att"][:n]

    def predict_prepared(self, images, wids):
        """Blocking variant: numpy rows after the device round-trip."""
        vals, idxs, att = self.predict_prepared_async(images, wids)
        return vals.cpu().numpy(), idxs.cpu().numpy(), att.cpu().numpy()

    def format_result(self, vals, idxs, att) -> dict:
        """One item's outputs -> the response dict (att maps as b64 PNGs,
        top-5 answer strings)."""
        return {"ans": [self.vocab_answers[int(i)] for i in idxs],
                "val": [float(v) for v in vals],
                "att": self._att_pngs(att)}

    def answer_batch(self, items: list[dict]) -> list[dict]:
        """All items in one forward (padded to a power-of-two bucket)."""
        if not items:
            return []
        if len(items) > MAX_BATCH:
            raise ValueError("batch too large: %d > %d"
                             % (len(items), MAX_BATCH))
        images = self._decode_raws(
            [base64.b64decode(it["visual"].split(",")[-1]) for it in items])
        wids = np.stack([self.encode_question(it["question"])
                         for it in items])
        vals, idxs, att = self.predict_prepared(images, wids)
        return [self.format_result(vals[j], idxs[j], att[j])
                for j in range(len(items))]

    def answer(self, image_b64: str, question: str) -> dict:
        return self.answer_batch(
            [{"visual": image_b64, "question": question}])[0]

    def prewarm(self, max_bucket: int = MAX_BATCH,
                concurrent: bool = True) -> list:
        """Run every power-of-two bucket once up front: on a card this
        captures each bucket's graph, so no request pays a capture.  With
        ``concurrent`` the buckets start from separate threads (their
        captures still take turns).  Returns the warmed bucket sizes."""
        buckets, b = [], 1
        while b <= min(max_bucket, MAX_BATCH):
            buckets.append(b)
            b *= 2
        errors = []

        def warm(n):
            try:
                images = np.zeros((n, self.size, self.size, 3), np.uint8)
                wids = np.zeros((n, self.maxlength), np.int32)
                self.predict_prepared(images, wids)
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        if concurrent:
            threads = [threading.Thread(target=warm, args=(n,), daemon=True)
                       for n in buckets]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for n in buckets:
                warm(n)
        if errors:
            raise errors[0]
        return buckets


class MicroBatcher:
    """Coalesce concurrent single requests into one forward (opt-in: the
    server's default, ``--batcher off``, runs one forward per request, each
    request thread on its own).  Request threads decode and tokenize before
    enqueueing and format their own response after; only the forward is
    shared.  The reference serves strictly one request per forward
    (demo_server.py:44-66).

    Two coalescing policies:

    * ``adaptive`` (default): a lone request dispatches immediately; a
      drain takes only the requests already queued (those that arrived
      while the previous forward ran), so an idle server adds no latency.
    * ``adaptive=False`` (fixed window): each batch is held open for up to
      ``max_wait_ms``.

    ``n_dispatchers`` drain loops share one queue, each running its
    forward itself, so up to that many coalesced batches overlap.
    ``submit`` blocks until the result row is ready and re-raises any
    batch-level failure in the caller's thread.
    """

    def __init__(self, engine: DemoEngine, max_batch: int = MAX_BATCH,
                 max_wait_ms: float = 4.0, autostart: bool = True,
                 adaptive: bool = True, n_dispatchers: int = 4):
        import queue

        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.adaptive = adaptive
        self.n_dispatchers = max(1, n_dispatchers)
        self._q = queue.Queue()
        self._threads: list = []
        if autostart:
            self.start()

    def start(self) -> None:
        if not self._threads:
            self._threads = [
                threading.Thread(target=self._loop, daemon=True)
                for _ in range(self.n_dispatchers)]
            for t in self._threads:
                t.start()

    def pending(self) -> int:
        return self._q.qsize()

    def submit(self, item: dict) -> dict:
        """Prepare in this thread, coalesce the forward, format here."""
        prepared = self.engine.prepare(item)
        done = threading.Event()
        slot: dict = {}
        self._q.put((prepared, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        vals, idxs, att = slot["row"]
        return self.engine.format_result(vals, idxs, att)

    def _loop(self) -> None:
        import queue
        import time

        while True:
            entries = [self._q.get()]
            if self.adaptive:
                while len(entries) < self.max_batch:
                    try:
                        entries.append(self._q.get_nowait())
                    except queue.Empty:
                        break
            else:
                deadline = time.monotonic() + self.max_wait_s
                while len(entries) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        entries.append(self._q.get(timeout=timeout))
                    except queue.Empty:
                        break
            self._run(entries)

    def _run(self, entries: list) -> None:
        try:
            images = np.stack([e[0][0] for e in entries])
            wids = np.stack([e[0][1] for e in entries])
            vals, idxs, att = self.engine.predict_prepared(images, wids)
            for j, (_, done, slot) in enumerate(entries):
                slot["row"] = (vals[j], idxs[j], att[j])
                done.set()
        except Exception as exc:  # noqa: BLE001 — re-raised in each caller
            for _, done, slot in entries:
                slot["error"] = exc
                done.set()


def make_handler(engine: DemoEngine, web_dir: str | None,
                 ckpt_root: str | None = None,
                 batcher: MicroBatcher | None = None):
    class Handler(BaseHTTPRequestHandler):
        def _cors(self):
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")

        def _json(self, obj, status=200):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self._cors()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_OPTIONS(self):
            self.send_response(200)
            self._cors()
            self.end_headers()

        def do_GET(self):
            if self.path == "/checkpoints":
                self._json({"checkpoints": list_checkpoints(ckpt_root)})
                return
            if self.path == "/health":
                self._json({"ok": True})
                return
            if web_dir is None:
                self.send_response(404)
                self.end_headers()
                return
            path = "index.html" if self.path in ("/", "") \
                else self.path.lstrip("/")
            full = os.path.realpath(os.path.join(web_dir, path))
            if (not full.startswith(os.path.realpath(web_dir) + os.sep)
                    or not os.path.isfile(full)):
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            ctype = ("text/html" if full.endswith(".html")
                     else "application/javascript" if full.endswith(".js")
                     else "text/css" if full.endswith(".css")
                     else "application/octet-stream")
            self.send_header("Content-Type", ctype)
            self.end_headers()
            with open(full, "rb") as f:
                self.wfile.write(f.read())

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                payload = json.loads(body)
                if self.path == "/batch":
                    out = {"results": engine.answer_batch(payload["items"])}
                elif self.path == "/checkpoint":
                    wanted = payload["name"]
                    match = [c for c in list_checkpoints(ckpt_root)
                             if c["name"] == wanted]
                    if not match:
                        raise KeyError("unknown checkpoint: %s" % wanted)
                    engine.load_checkpoint(match[0]["path"])
                    out = {"ok": True, "loaded": match[0]}
                elif batcher is not None:
                    # concurrent single requests coalesce into one forward
                    # (ThreadingHTTPServer gives each request a thread)
                    out = batcher.submit(payload)
                else:
                    out = engine.answer(payload["visual"],
                                        payload["question"])
                self._json(out)
            except Exception as exc:  # noqa: BLE001 — report to client
                self._json({"error": str(exc)}, status=400)

        def log_message(self, fmt, *args):
            print("[demo]", fmt % args)

    return Handler


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_opt",
                        default="configs/vqa2/mutan_noatt_train.yaml")
    parser.add_argument("--dir_logs", default=None, type=str,
                        help="VQA run dir (its best_* files are loaded); "
                             "random init if omitted")
    parser.add_argument("--ckpt_root", default=None, type=str,
                        help="dir of run dirs for GET /checkpoints + hot-swap")
    parser.add_argument("--port", default=3456, type=int)
    parser.add_argument("--ip", default="127.0.0.1", type=str)
    parser.add_argument("--vocab_path", default=None, type=str,
                        help="processed dir with vocab pickles")
    parser.add_argument("--serve_web", action="store_true",
                        help="also serve the bundled demo_web client")
    parser.add_argument("--batcher", default="off",
                        choices=["adaptive", "window", "off"],
                        help="POST / coalescing policy.  'off': one forward "
                             "per request, each request thread on its own; "
                             "'adaptive' coalesces with no idle latency "
                             "over 4 dispatchers; 'window' holds each "
                             "batch open for --batch_window_ms")
    parser.add_argument("--batch_window_ms", type=float, default=4.0,
                        help="fixed coalescing window, used only with "
                             "--batcher window (0 also disables the "
                             "batcher)")
    parser.add_argument("--prewarm", action="store_true",
                        help="run (on a card: capture) EVERY batch bucket "
                             "before serving; without it only the "
                             "single-request bucket is warmed")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    return parser


def create_server(argv=None) -> DemoHTTPServer:
    """Everything ``main`` does short of serving: the models, the engine
    (warmed), the handler and the bound server (``server.engine``)."""
    from ..core import config as config_lib
    from ..core.checkpoint import load_vqa_model
    from ..data import synthetic
    from ..engines.vqa_engine import init_vqa_params
    from ..models import convnets, factory

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port runs on the "
                           "card; pass --device cpu to run on the CPU")
    options = config_lib.resolve_options({}, args.path_opt, {})
    if args.vocab_path:
        import pickle
        with open(os.path.join(args.vocab_path,
                               "wid_to_word.pickle"), "rb") as f:
            wid_to_word = pickle.load(f)
        vocab_words = [wid_to_word[i] for i in sorted(wid_to_word)]
        with open(os.path.join(args.vocab_path,
                               "aid_to_ans.pickle"), "rb") as f:
            vocab_answers = pickle.load(f)
    else:
        print("WARNING: no --vocab_path; using synthetic vocab (smoke only)")
        vocab_words, vocab_answers = synthetic.synthetic_vocab(
            2000, options["vqa"]["nans"])

    size = options["coco"].get("size", 448)
    cnn = convnets.factory({"arch": options["coco"]["arch"],
                            "pooling": False})
    convnets.init_resnet(cnn, size)
    model = factory.factory_vqa(options["model"], vocab_words, vocab_answers)
    init_vqa_params(model, seed=0)
    model.to(device)
    if args.dir_logs and load_vqa_model(model,
                                        os.path.join(args.dir_logs, "best")):
        print("Loaded VQA checkpoint from", args.dir_logs)
    attention = "Att" in options["model"]["arch"] \
        and "NoAtt" not in options["model"]["arch"]
    engine = DemoEngine(options, model, cnn, vocab_words, vocab_answers,
                        attention)

    if args.prewarm:
        print("Prewarming every batch bucket...")
        print("  warmed buckets:", engine.prewarm())
    else:
        print("Warming up the predict path (bucket 1)...")
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(np.zeros((size, size, 3), np.uint8)).save(
            buf, format="JPEG")
        engine.answer(base64.b64encode(buf.getvalue()).decode(), "warm up")

    web_dir = (os.path.join(os.path.dirname(__file__), "demo_web")
               if args.serve_web else None)
    batcher = None
    if args.batcher != "off" and args.batch_window_ms > 0:
        batcher = MicroBatcher(engine, max_wait_ms=args.batch_window_ms,
                               adaptive=args.batcher == "adaptive")
    server = DemoHTTPServer(
        (args.ip, args.port), make_handler(engine, web_dir, args.ckpt_root,
                                           batcher))
    server.engine = engine
    return server


def main(argv=None):
    server = create_server(argv)
    host, port = server.server_address[:2]
    print("Serving VQA demo on http://%s:%d" % (host, port))
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
