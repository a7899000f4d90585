"""Utilities of the port (counterpart of ``pgdrome_tpu/utils``)."""
