"""Input of the port: the per-host split and the synthetic sources
(``data/input_pipeline.py``)."""

from .input_pipeline import (  # noqa: F401
    InputContext,
    pack_sequences,
    synthetic_classification,
)
