"""Math helpers in the reference's row-vector conventions."""
from softwarerenderer_tpu_torch.utils import mathlib  # noqa: F401
