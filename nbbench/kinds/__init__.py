"""The traffic kinds: ``kinds/<kind>.py`` drives the program for a traffic
file whose ``kind`` is ``<kind>``, through ``run(cell, seed, seconds,
trace, device, t_start)``."""
