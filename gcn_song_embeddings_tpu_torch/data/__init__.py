from gcn_song_embeddings_tpu_torch.data.graph import CSR, SongGraph, z_normalize
from gcn_song_embeddings_tpu_torch.data.synth import make_synthetic_dataset

__all__ = ["CSR", "SongGraph", "make_synthetic_dataset", "z_normalize"]
