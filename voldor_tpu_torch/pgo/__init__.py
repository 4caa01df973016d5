"""7-DoF (Sim3-style) pose-graph optimisation: a dense LM (port of
``voldor_tpu/pgo``)."""
