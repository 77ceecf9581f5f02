"""cruise_control_tpu_torch — the PyTorch/CUDA port of ``cruise_control_tpu``.

Same module layout as the JAX package, so each module's counterpart is found
at the same path.  The port imports torch, numpy and the standard library
only.  Entry points run on ``torch.device("cuda")`` unless the caller passes
another device; hand-written kernels live under ``ops/``.
"""

__version__ = "0.1.0"
