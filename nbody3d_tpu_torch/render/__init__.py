"""Headless rendering: point-splat frames (the ``splat_resolve`` kernel on a
card) and PNG output."""
