"""Initial-condition generators (numpy only, seeded)."""

from nbody3d_tpu_torch.models.galaxy import (  # noqa: F401
    generate_galaxies,
    mass_to_radius,
    random_galaxy_configs,
)
from nbody3d_tpu_torch.models.plummer import plummer_sphere  # noqa: F401
from nbody3d_tpu_torch.models.sphere import fibonacci_shell, uniform_sphere  # noqa: F401
from nbody3d_tpu_torch.models.registry import PRESETS, make_preset  # noqa: F401
