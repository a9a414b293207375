"""The data layer of the port (src/repro/data): the synthetic token
pipeline and the paper's semantic ordering of a corpus."""
from repro_torch.data.ordering import mean_pool_embeddings, semantic_order
from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticLMSource,
    TokenPipeline,
    pack_documents,
)

__all__ = [
    "DataConfig",
    "SyntheticLMSource",
    "TokenPipeline",
    "mean_pool_embeddings",
    "pack_documents",
    "semantic_order",
]
