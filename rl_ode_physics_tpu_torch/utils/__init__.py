"""Math, PRNG, transform and host-side utilities: ``quat``, ``transforms``
and ``prng`` are imported with the subpackage (none builds a kernel)."""

from rl_ode_physics_tpu_torch.utils import prng, quat, transforms

__all__ = ["quat", "transforms", "prng"]
