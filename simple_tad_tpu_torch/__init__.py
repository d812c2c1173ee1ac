"""simple_tad_tpu_torch: the PyTorch / CUDA port of simple_tad_tpu for an
NVIDIA H100.

Same layout and module names as the JAX package (models/, ops/, eval/,
train/, data/, utils/, cli/).  The hand-written CUDA kernels live in csrc/ and are
built at first use by kernels/build.py.  Importing the package imports
torch and numpy only: no jax, flax, pandas or cv2.
"""

from simple_tad_tpu_torch.models import create_model, list_models

__all__ = ["create_model", "list_models"]
