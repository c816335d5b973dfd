"""Bundled reference-earth data tables (generated, not copied)."""

from pysurfinv_tpu_torch.data.prem import prem_model  # noqa: F401
