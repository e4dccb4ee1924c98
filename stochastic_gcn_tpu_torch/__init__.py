"""stochastic_gcn_tpu_torch: the PyTorch / CUDA port of the JAX package.

Same module names as the JAX package, so every counterpart is easy to
find.  Runs on an explicit torch device; the two TPU Pallas kernels and
the fanout term's backward are hand-written CUDA kernels for Hopper
(``csrc/``), built at first use, with plain PyTorch versions beside them
for CPU tensors.  Imports torch, numpy and scipy, never JAX nor the JAX
package.  Ported so far, on one device: training (``Trainer.sgd_train``,
``cli/train.py``) and inference (``Trainer.predict``, ``cli/infer.py``)
with the NS, CV, CVD, det-dropout and Exact estimators, and the
gradient-variance harness (``Trainer.gradient_variance``).
"""

__version__ = "0.1.0"

from .config import Config, parse_flags

__all__ = ["Config", "parse_flags"]
