"""PyTorch/CUDA port of ``rl_ode_physics_tpu``.

A second package beside the JAX one, which stays the reference: the same
``WorldState`` fields, step semantics and capacities, with a leading world
axis on every tensor and hand-written Hopper kernels where the JAX package
has Pallas ones. It imports ``torch`` and never ``jax`` or
``rl_ode_physics_tpu``. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""
