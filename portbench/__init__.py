"""The port's benchmark: whole SLAM sessions through `System`, one cell per
run (see README.md and run.py)."""
