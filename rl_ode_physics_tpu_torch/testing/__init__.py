"""Validation oracles: the port's copy of the independent float64 NumPy
QuickStep referee (BASELINE: <=1e-5 relative trajectory error against it
over 1k steps). ``referee.py`` imports numpy alone, so it runs wherever
the port runs, the card's machine among them.
"""

from rl_ode_physics_tpu_torch.testing.referee import (
    RefereeConfig, referee_step, state_to_numpy)

__all__ = ["RefereeConfig", "referee_step", "state_to_numpy"]
