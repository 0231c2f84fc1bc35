"""The port's benchmark: the yardstick behind ``rtbench/run.py``."""
