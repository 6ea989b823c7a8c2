"""Math, PRNG, transform and host-side utilities: ``quat``, ``transforms``
and ``prng`` are imported with the subpackage (none builds a kernel). The
measurement tools (``capacity_audit``, ``profile_step``, ``roofline``,
``sap_cost_analysis``, ``orientation_probe`` and the rest, each run as
``python3 -m rl_ode_physics_tpu_torch.utils.<name>``) and the card's bound
model (``bounds``) are imported by name."""

from rl_ode_physics_tpu_torch.utils import prng, quat, transforms

__all__ = ["quat", "transforms", "prng"]
