"""Convert a trained reference (PyTorch) checkpoint into the JAX package's
checkpoint files, which both packages read (port of
``cli/port_checkpoint.py``; same flags, same files).

* ``--kind vqa``: a VQA classifier from reference ``train.py``
  (``best_model.pth.tar`` / ``ckpt_model.pth.tar``) -> the VQA scheme's
  ``best_*`` and ``ckpt_*`` model and info files in ``--out``, with no
  optim file: ``cli/train.py --resume best`` and the CX CLI's pretrained
  VQA load take it, and the optimizer starts fresh (the loader warns, as
  the reference's does, ``train.py:344-364``).
* ``--kind cx``: a CX model from reference ``counterexamples.py``
  (``ckpt/model.ckpt``, the VQA model nested under ``vqa_model.``) -> a
  params msgpack for ``cli/counterexamples.py --init_params``.

``--src`` is a torch ``.pth`` / ``.pth.tar`` (read with
``weights_only=True``) or an ``.npz`` of the same keys.  The key mapping
and the architecture's inference are ``models/from_reference.py``; the
trees are ``models/to_jax.py``'s::

    python -m vqa_counterexamples_tpu_torch.cli.port_checkpoint \\
        --src best_model.pth.tar --kind vqa --out logs/vqa2/ported
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", required=True, type=str,
                        help="torch state_dict (.pth/.pth.tar) or .npz")
    parser.add_argument("--kind", required=True, choices=["vqa", "cx"])
    parser.add_argument("--out", required=True, type=str,
                        help="vqa: output dir for the checkpoint triple; "
                             "cx: output .msgpack params file")
    parser.add_argument("--cx_model", type=str, default=None,
                        help="override CX model inference (NeuralModel, "
                             "PairwiseModel, ...)")
    args = parser.parse_args(argv)

    from ..core import checkpoint as ckpt_lib
    from ..core import msgpack_tree
    from ..models import from_reference, to_jax

    sd = from_reference.load_state_dict(args.src)
    if args.kind == "vqa":
        ported, arch = from_reference.vqa_state_dict(sd)
        ckpt_lib.write_vqa_params(
            to_jax.vqa_params(ported), args.out,
            {"epoch": 0, "arch": arch, "ported_from": args.src})
        print("Ported %s VQA checkpoint -> %s (best_/ckpt_ triple; optimizer "
              "state starts fresh)" % (arch, args.out))
    else:
        ported, model, vqa_arch = from_reference.cx_state_dict(
            sd, cx_model=args.cx_model)
        msgpack_tree.save(to_jax.cx_params(ported), args.out)
        print("Ported %s CX checkpoint (vqa_model: %s) -> %s; load with "
              "counterexamples --init_params" % (model, vqa_arch, args.out))


if __name__ == "__main__":
    main()
