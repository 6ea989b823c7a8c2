"""The benchmark harness of the PyTorch port (``rl_ode_physics_tpu_torch``).

``h100_bench/run.py`` is the command; this package is its yardstick: the
manifest (``manifest``), the seeded worlds and resets (``scenes``,
``traffic``), the measured window (``window``), the trace reduction
(``trace``), the statistics (``stats``) and the checks (``checks``). The
configurations, traffic mixes, per-layer metric readers and plain
references sit in files of their own beside it, found by name.
"""
