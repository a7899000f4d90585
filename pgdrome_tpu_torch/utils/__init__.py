"""Utilities of the port (counterpart of ``pgdrome_tpu/utils``):
configuration, metrics, load separation and the native host helpers."""

from pgdrome_tpu_torch.utils.pgd_config import PGDConfig
from pgdrome_tpu_torch.utils.profiling import EnrichmentMetrics
from pgdrome_tpu_torch.utils.separation import separate, separate_rank1, separation_error
from pgdrome_tpu_torch.utils import native

__all__ = [
    "PGDConfig",
    "EnrichmentMetrics",
    "separate",
    "separate_rank1",
    "separation_error",
    "native",
]
