"""The plain reference (float64 PyTorch) and the comparisons that decide a
run's ``correct``.  Imports nothing of the program."""
