"""Batched vademecum sweeps (counterpart of ``pgdrome_tpu/parallel``)."""
