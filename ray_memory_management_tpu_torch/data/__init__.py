"""Data library: distributed, block-based datasets for the card's input pipelines.

The reference's ``ray.data`` (python/ray/data/ — Dataset lazy plans,
block model, task/actor compute, push-based shuffle, DatasetPipeline).
"""

from .block import BlockAccessor, BlockMetadata  # noqa: F401
from .dataset import Dataset, GroupedData  # noqa: F401
from .pipeline import DatasetPipeline  # noqa: F401
from .plan import ActorPoolStrategy  # noqa: F401
from .read_api import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)
