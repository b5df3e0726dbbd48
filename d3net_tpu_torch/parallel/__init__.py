"""Data-parallel training across processes (``mesh``) and its multi-process
dry run (``dryrun``): the counterpart of ``d3net_tpu/parallel/``."""
