"""7-DoF (Sim3-style) pose-graph optimisation: dense LM and LM + matrix-free
CG (port of ``voldor_tpu/pgo``)."""
