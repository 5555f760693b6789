"""Training of the port (``repro.train``): the step, the loop, checkpoints and
the fault-tolerance hooks."""
