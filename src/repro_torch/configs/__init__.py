"""Architecture configs: the 10 assigned architectures and the input
shapes, as in the reference (``base``, ``registry`` and the arch files
are its code; ``shapes`` describes inputs as (shape, torch dtype))."""

from repro_torch.configs import registry, shapes  # noqa: F401
from repro_torch.configs.base import ArchConfig  # noqa: F401
