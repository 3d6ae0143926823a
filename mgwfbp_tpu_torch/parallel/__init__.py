"""Parallelism of the port (counterpart of ``mgwfbp_tpu/parallel``): the
merge solver and cost models, the hook-driven merged all-reduce, process
groups, and dense attention."""
