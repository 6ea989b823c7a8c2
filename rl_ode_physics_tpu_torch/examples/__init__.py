"""Programs that drive the port end to end, each run as
``python -m rl_ode_physics_tpu_torch.examples.<name>``: the ES trainer
(``rl_training``), a batched rollout (``rl_rollout``), a jointed arm
(``articulated``) and the player-only server and client pair
(``minimal_server``, ``minimal_client``)."""
