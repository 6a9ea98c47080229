"""Feature extraction CLI (port of the JAX package's ``cli/extract.py``;
reference ``extract.py``).

Runs a ResNet-152 over a directory of JPEGs (448x448, ImageNet
normalization) and writes, per split:

* ``{split}set.att.npy`` (C-order float32, or bfloat16 bit-views with
  ``--feat-dtype bfloat16``, written incrementally through a memmap into
  ``{split}set.att.tmp.npy`` and renamed at the end): the att maps (N, 14,
  14, 2048) NHWC (``--att_store hdf5`` instead writes an ``att`` dataset
  into the .hdf5 for reference-format parity, ``both`` writes both);
* ``{split}set.hdf5`` with dataset ``noatt`` (N, 2048): the true spatial
  mean of ``att`` (extract.py:123-124 semantics).  It needs h5py: where
  h5py does not import, ``--att_store npy`` writes no ``.hdf5`` and says
  so, and ``--att_store hdf5|both`` raises ``ImportError``;
* ``{split}set.npy``: ``noatt`` as an array;
* ``{split}set.txt``: image names in row order (the name <-> index
  contract, extract.py:148-150).

Host pipeline: a prefetch thread decodes the next batch while the card runs
this one (double buffering); the native decoder (``data/native_decoder``)
takes the JPEGs on its C++ thread pool, PIL the rest (every image where the
library cannot be built).  Images cross to the card as uint8 and are
normalized there; the trunk computes in bf16.  The device is ``cuda``; with
no card visible the CLI refuses to run unless ``--device cpu`` is given.
``--mesh`` and ``--distributed`` raise ``NotImplementedError`` (ROADMAP.md,
Queue 1 #12).  The short tail batch runs as it is.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dir_data", default="data/coco", type=str)
    parser.add_argument("--dataset", default="coco", type=str,
                        choices=["coco", "vgenome"],
                        help="coco: raw/{train2014,val2014,test2015}; "
                             "vgenome: raw/images flat dir (reference "
                             "extract.py:56-77, vgenome.py:72-92)")
    parser.add_argument("--data_split", default="train", type=str,
                        choices=["train", "val", "test"])
    parser.add_argument("--arch", default="fbresnet152", type=str)
    parser.add_argument("--mode", default="both", type=str,
                        choices=["att", "noatt", "both"])
    parser.add_argument("--att_store", default="npy", type=str,
                        choices=["npy", "hdf5", "both"],
                        help="att-map container: npy (a memmap the "
                             "training loader reads) or the reference's "
                             "hdf5 (needs h5py)")
    parser.add_argument("--feat-dtype", default="float32", dest="feat_dtype",
                        choices=["float32", "bfloat16"],
                        help="element dtype of the .npy outputs; bfloat16 "
                             "files are written as a uint16 bit-view so "
                             "stock numpy can open them (.hdf5 stays f4)")
    parser.add_argument("--size", default=448, type=int)
    parser.add_argument("-b", "--batch_size", default=80, type=int)
    parser.add_argument("--workers", default=0, type=int,
                        help="decode threads (0 = all host cores)")
    parser.add_argument("--weights", default=None, type=str,
                        help="torch state_dict .pth to load (else random)")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="extract N random images (smoke mode)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="shard each batch over a mesh (not ported)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host bootstrap (not ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    return parser


def _image_dir(args) -> str:
    if args.dataset == "vgenome":
        # VG images sit in one flat raw/images dir, train split only
        # (reference extract.py:66-77, vgenome.py:72-92)
        if args.data_split != "train":
            raise ValueError("train split is required for vgenome")
        return os.path.join(args.dir_data, "raw", "images")
    subdir = {"train": "train2014", "val": "val2014",
              "test": "test2015"}[args.data_split]
    return os.path.join(args.dir_data, "raw", subdir)


def _to_disk(att: torch.Tensor, bf16: bool) -> np.ndarray:
    """A device batch as the .npy's rows: f32, or bf16 bits as uint16."""
    if bf16:
        att = att.to(torch.bfloat16).view(torch.int16)
    return att.cpu().numpy().view(np.uint16 if bf16 else np.float32)


def main(argv=None, stats=None):
    """``stats``: optional dict filled with per-phase timings (``init_s``,
    ``first_batch_s`` including the first transfers and cuDNN's first
    calls, ``steady_img_per_sec``, ``finalize_s``)."""
    from ..data.native_decoder import NativeImageDecoder, decode_files
    from ..data.native_decoder import pil_decode
    from ..models import convnets

    args = build_parser().parse_args(argv)
    for flag in ("mesh", "distributed"):
        if getattr(args, flag):
            raise NotImplementedError(
                "--%s is not ported to the PyTorch package yet (ROADMAP.md, "
                "Queue 1 #12)" % flag)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port runs on the "
                           "card; pass --device cpu to run on the CPU")
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is None and args.att_store != "npy":
        raise ImportError("--att_store %s writes an .hdf5 file and needs "
                          "h5py, which does not import here"
                          % args.att_store)

    stats = stats if stats is not None else {}
    t_init = time.time()
    model = convnets.factory({"arch": args.arch, "pooling": False})
    convnets.init_resnet(model, image_size=args.size)
    if args.weights:
        convnets.load_torch_resnet152(model, args.weights)
        print("Loaded weights from", args.weights)
    else:
        print("WARNING: no --weights given; extracting with random init "
              "(smoke only)")
    model.to(device).eval()
    staged = device.type == "cuda"

    @torch.no_grad()
    def run_forward(batch_host: np.ndarray):
        x = torch.from_numpy(batch_host)
        if staged:
            x = x.pin_memory().to(device, non_blocking=True)
        if x.dtype == torch.uint8:
            # images cross as uint8 and normalize on the device; the
            # synthetic path feeds f32 directly
            x = convnets.normalize_images_device(x)
        att = model(x)                       # (B, 14, 14, 2048) f32
        return att, att.mean(dim=(1, 2))     # the true spatial mean

    # ---- enumerate inputs ----
    workers = args.workers or os.cpu_count() or 1
    if args.synthetic:
        names = ["synthetic_%06d.jpg" % i for i in range(args.synthetic)]
        rng = np.random.default_rng(0)

        def load_batch(batch_names, pool):
            # one draw per image, in name order (the JAX CLI's draws)
            return rng.normal(size=(len(batch_names), args.size, args.size,
                                    3)).astype(np.float32)
    else:
        img_dir = _image_dir(args)
        names = sorted(n for n in os.listdir(img_dir)
                       if n.lower().endswith((".jpg", ".jpeg", ".png")))
        native = NativeImageDecoder(n_threads=workers)

        def load_batch(batch_names, pool):
            paths = [os.path.join(img_dir, nm) for nm in batch_names]
            if native.available:   # C++ pool; PIL for the items it refuses
                return decode_files(native, paths, args.size)
            return np.stack(list(pool.map(
                lambda p: pil_decode(p, args.size), paths)))

    stats["init_s"] = time.time() - t_init
    n = len(names)
    print("Extracting %d images (%s)" % (n, args.data_split))
    out_dir = os.path.join(args.dir_data, "extract",
                           "arch,%s_size,%d" % (args.arch, args.size))
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "%sset" % args.data_split)

    spatial = args.size // 32
    want_att = args.mode in ("att", "both")
    bf16 = args.feat_dtype == "bfloat16"
    att_npy_tmp = prefix + ".att.tmp.npy"
    h5 = h5py.File(prefix + ".hdf5", "w") if h5py is not None else None
    if h5 is None:
        print("No %s.hdf5 written: h5py does not import here (the .npy and "
              ".txt files hold the same features)" % prefix)
    noatt_all = np.empty((n, 2048), np.float32)
    # the prefetcher is a thread of its own so that the decode pool is
    # never waited on by its own consumer
    with ThreadPoolExecutor(max_workers=1) as prefetcher, \
            ThreadPoolExecutor(max_workers=workers) as pool:
        ds_att = mm_att = None
        try:
            if want_att and args.att_store in ("hdf5", "both"):
                ds_att = h5.create_dataset(
                    "att", (n, spatial, spatial, 2048), dtype="f4")
            if want_att and args.att_store in ("npy", "both"):
                mm_att = np.lib.format.open_memmap(
                    att_npy_tmp, mode="w+",
                    dtype=np.uint16 if bf16 else np.float32,
                    shape=(n, spatial, spatial, 2048))

            def decode_batch(start):
                return load_batch(names[start:start + args.batch_size], pool)

            # double buffering: decode batch i+1 while the card runs batch i
            future = prefetcher.submit(decode_batch, 0) if n else None
            t0 = time.time()
            t_steady = None
            done = 0
            for start in range(0, n, args.batch_size):
                batch = future.result()
                nxt = start + args.batch_size
                if nxt < n:
                    future = prefetcher.submit(decode_batch, nxt)
                att, noatt = run_forward(batch)
                end = start + batch.shape[0]
                if ds_att is not None:
                    ds_att[start:end] = att.cpu().numpy()
                if mm_att is not None:
                    mm_att[start:end] = _to_disk(att, bf16)
                noatt_all[start:end] = noatt.cpu().numpy()
                done = end
                if start == 0:
                    stats["first_batch_s"] = time.time() - t0
                    t_steady = time.time()
                if (start // args.batch_size) % 10 == 0:
                    print("  %d/%d (%.1f images/sec)"
                          % (done, n, done / (time.time() - t0)))
            if done > args.batch_size:
                stats["steady_img_per_sec"] = (
                    (done - args.batch_size)
                    / max(time.time() - t_steady, 1e-9))
            t_fin = time.time()
            if h5 is not None:
                h5.create_dataset("noatt", data=noatt_all, dtype="f4")
            if mm_att is not None:
                mm_att.flush()
                del mm_att
        finally:
            if h5 is not None:
                h5.close()
    if want_att and args.att_store in ("npy", "both"):
        os.replace(att_npy_tmp, prefix + ".att.npy")
    np.save(prefix + ".npy", _to_disk(torch.from_numpy(noatt_all), bf16))
    with open(prefix + ".txt", "w") as f:
        for name in names:
            f.write(name + "\n")
    stats["finalize_s"] = time.time() - t_fin
    rate = n / (time.time() - t0)
    print("Done: %s.{%snpy,txt} (%.1f images/sec)"
          % (prefix, "hdf5," if h5 is not None else "", rate))
    return prefix


if __name__ == "__main__":
    main()
