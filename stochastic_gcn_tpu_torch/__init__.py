"""stochastic_gcn_tpu_torch — the PyTorch / CUDA port of stochastic_gcn_tpu.

Same module names as the JAX package, so every counterpart is easy to
find.  Runs on an explicit torch device; the two TPU Pallas kernels and
the fanout term's backward are hand-written CUDA kernels for Hopper
(``csrc/``), built at first use, with plain PyTorch versions beside them
for CPU tensors.  Imports torch, numpy and scipy, never JAX.  Ported so
far: single-device CV+PP training (``Trainer.sgd_train``,
``cli/train.py``) and CV inference (``Trainer.predict``,
``cli/infer.py``).
"""

__version__ = "0.1.0"

from .config import Config, parse_flags

__all__ = ["Config", "parse_flags"]
