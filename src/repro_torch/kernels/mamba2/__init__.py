from .ops import (Mamba2Function, mamba2_ssd, mamba2_ssd_backward,
                  mamba2_ssd_grad)
from .ref import mamba2_ref, mamba2_ref_bwd

__all__ = ["Mamba2Function", "mamba2_ssd", "mamba2_ssd_backward",
           "mamba2_ssd_grad", "mamba2_ref", "mamba2_ref_bwd"]
