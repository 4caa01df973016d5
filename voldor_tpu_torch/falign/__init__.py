"""Dense pairwise frame alignment (mapping links): batched LM over pairs,
analytic Jacobians (port of ``voldor_tpu/falign``)."""
