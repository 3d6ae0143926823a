"""Parallel attention of the port (counterpart of ``mgwfbp_tpu/parallel``)."""
