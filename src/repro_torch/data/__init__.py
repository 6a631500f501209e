"""Token data pipelines: synthetic and local-file sources."""
from .pipeline import (DataConfig, SyntheticLM, TextFileLM,  # noqa: F401
                       make_pipeline)
