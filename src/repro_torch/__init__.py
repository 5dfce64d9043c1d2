"""PyTorch/CUDA port of the resilient distributed boosting protocol.

A second package beside the JAX reference (``src/repro``): the same
module names, checked against the reference on the same inputs.  It
imports torch and numpy and never jax or anything under ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); there is no silent CPU
fallback.
"""

import torch

# The parity bar holds protocol outputs bit-equal to the reference and
# float diagnostics to rtol 1e-5.  TF32 rounds float32 matmul and
# convolution inputs to 10 mantissa bits, far outside that bar, so it
# stays off for every caller of the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
