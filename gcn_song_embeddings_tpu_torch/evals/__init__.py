from gcn_song_embeddings_tpu_torch.evals.metrics import (  # noqa: F401
    average_degree,
    coverage,
    hit_rate,
    inter_diversity,
    intra_diversity,
    low_co_accuracy,
    low_degree_accuracy,
    mrr,
)
