"""cales_tpu — a JAX/XLA incompressible DNS/LES framework with the
capabilities of the CaNS-World/CaLES reference."""

__version__ = "0.1.0"

from .config import Config, validate  # noqa: F401
from .grid import Grid, make_grid, make_grid_from_config  # noqa: F401
