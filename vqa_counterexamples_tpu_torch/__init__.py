"""vqa_counterexamples_tpu_torch — the PyTorch / CUDA port of
``vqa_counterexamples_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its layout
(``core/``, ``data/``, ``ops/``, ``models/``, ``engines/``, ``cli/``) so each
module's counterpart is found under the same name.  It imports ``torch`` and
numpy and never ``jax``.

What is ported so far is the main path, NeuralCX training and scoring over a
frozen MutanNoAtt + BayesianUniSkip backbone with the q/v/z frozen-backbone
caches (``cli/counterexamples.py --synthetic N --z_cache --epochs E
--test``), and the VQA pretraining of that backbone (``cli/train.py``).
The seven TPU kernels these paths reach (the GRU forward with shared or
per-gate masks and its backward, the vfeat forward and backward, the
mixture head, MUTAN's Tucker fusion) are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/cuda/``).
"""

__version__ = "0.1.0"
