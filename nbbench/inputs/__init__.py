"""Frozen copies of the program's initial-condition generators, one module
each, found by the configuration's ``generator`` key.  Each module has
``make(config, seed) -> (pos_mass (N, 4) float32, vel (N, 4) float32)``
and imports nothing of the program, so a later change to the program's
presets cannot change what the benchmark runs."""
