"""The multi-device layer on ``torch.distributed`` (one process per
device): the (dp, graph) mesh, the sharded table gather, sharded
training, the edge-partitioned walks and catalog-sharded serving."""

from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from gcn_song_embeddings_tpu_torch.parallel.train_step import (  # noqa: F401
    ShardedTrainer,
)

# serve_sharded pulls in the serving stack; training-side imports of
# ``parallel`` should not pay for it
_LAZY = ("ShardedServeIndex", "ShardedServingFrontend")


def __getattr__(name):
    if name in _LAZY:
        from gcn_song_embeddings_tpu_torch.parallel import serve_sharded

        return getattr(serve_sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
