from gcn_song_embeddings_tpu_torch.models.baselines.base import (  # noqa: F401
    EmbeddingModel,
    PredictionModel,
)
from gcn_song_embeddings_tpu_torch.models.baselines.graphsage import (  # noqa: F401
    GraphSAGE,
)
from gcn_song_embeddings_tpu_torch.models.baselines.mf import (  # noqa: F401
    ColTrackCF,
    TrackTrackCF,
)
from gcn_song_embeddings_tpu_torch.models.baselines.node2vec import (  # noqa: F401
    FastNode2Vec,
)
from gcn_song_embeddings_tpu_torch.models.baselines.pinsage_wrapper import (  # noqa: F401
    PinSageWrapper,
)
from gcn_song_embeddings_tpu_torch.models.baselines.similarity import (  # noqa: F401
    AdamicAdar,
    JaccardIndex,
    Preferential,
)
from gcn_song_embeddings_tpu_torch.models.baselines.simple import (  # noqa: F401
    EmbLoader,
    JaccardFast,
    PersPageRank,
    Random,
    WalkEmbedHybrid,
)
