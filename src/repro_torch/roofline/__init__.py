"""Hardware profiles for the port's analytic cost model."""
from . import hw  # noqa: F401
from .hw import (HardwareProfile, all_profiles, get_profile,  # noqa: F401
                 register_profile)
