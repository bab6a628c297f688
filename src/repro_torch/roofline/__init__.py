"""Hardware profiles and the one-device roofline of the port's analytic
cost model."""
from . import hw  # noqa: F401
from .analysis import (RooflineTerms, analytic_hbm_bytes,  # noqa: F401
                       extrapolate, model_flops)
from .hw import (HardwareProfile, all_profiles, get_profile,  # noqa: F401
                 register_profile)
