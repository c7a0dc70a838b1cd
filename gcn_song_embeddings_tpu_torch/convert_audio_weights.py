"""Convert pretrained audio-embedder checkpoints to the ``.npz`` both
packages load.

The port's counterpart of ``scripts/convert_audio_weights.py``, without
JAX: a thin CLI over ``models.audio_embedders``' converters (torchopenl3
audio model and torchvggish state_dicts, musicnn TF-1 variables -> the
JAX package's weight trees, saved under their dotted names).  Run where
the checkpoint is (no network is used)::

    python -m gcn_song_embeddings_tpu_torch.convert_audio_weights \\
        openl3 state_dict.pt openl3.npz
    python -m gcn_song_embeddings_tpu_torch.convert_audio_weights \\
        vggish vggish.pt vggish.npz
    python -m gcn_song_embeddings_tpu_torch.convert_audio_weights \\
        musicnn tfvars.npz musicnn.npz

then pass the ``.npz`` as ``--feature-weights`` (either package's CLI).
For musicnn the source is an ``.npz`` of the checkpoint's name -> tensor
map, or a TF checkpoint directory where TensorFlow is installed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.models.audio_embedders import (
    convert_musicnn,
    convert_openl3,
    convert_vggish,
    save_weights,
)


def load_tf_variables(src: str) -> dict:
    """musicnn sources: an ``.npz`` of name -> tensor, or a TF checkpoint
    path or directory (needs TensorFlow)."""
    if src.endswith(".npz"):
        with np.load(src) as z:
            return {k: z[k] for k in z.files}
    import tensorflow as tf  # only for raw checkpoints

    if os.path.isdir(src):
        src = tf.train.latest_checkpoint(src) or src
    reader = tf.train.load_checkpoint(src)
    return {n: reader.get_tensor(n)
            for n in reader.get_variable_to_shape_map()}


def load_state_dict(src: str) -> dict:
    """A torch checkpoint's state_dict: plain state_dicts load under the
    safe ``weights_only`` unpickler; a pickled model object needs full
    unpickling, which runs code from the file, so only for checkpoints
    you trust."""
    try:
        sd = torch.load(src, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 -- any refusal of the safe unpickler
        print("note: not a plain state_dict — falling back to full "
              "unpickling (only convert checkpoints you trust)",
              file=sys.stderr)
        sd = torch.load(src, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="gcn_song_embeddings_tpu_torch.convert_audio_weights")
    ap.add_argument("model", choices=("openl3", "vggish", "musicnn"))
    ap.add_argument("src", help="torch .pt state_dict (openl3/vggish) or "
                                "TF checkpoint dir / variables .npz "
                                "(musicnn)")
    ap.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)
    if args.model == "musicnn":
        params = convert_musicnn(load_tf_variables(args.src))
    else:
        convert = convert_openl3 if args.model == "openl3" else convert_vggish
        params = convert(load_state_dict(args.src))
    save_weights(params, args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
