"""Plain float32 references of the benchmark's configurations, one module a
configuration (``<config>.py``), and the driver that trains and scores
with them (``driver.py``).  They import torch and numpy only."""
