from gcn_song_embeddings_tpu_torch.models.baselines.base import (  # noqa: F401
    EmbeddingModel,
    PredictionModel,
)
from gcn_song_embeddings_tpu_torch.models.baselines.simple import (  # noqa: F401
    EmbLoader,
    PersPageRank,
    Random,
)
