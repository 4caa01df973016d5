"""Multi-device execution of the port (counterpart of voldor_tpu/parallel)."""
