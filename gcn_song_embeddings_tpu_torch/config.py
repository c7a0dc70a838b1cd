"""Typed configuration (own copy of gcn_song_embeddings_tpu/config.py).

Every knob is an explicit dataclass field with the reference default,
serializable to/from JSON.  Field names and defaults match the JAX
package, so a run config written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class WalkConfig:
    """Random-walk / PPR neighborhood sampling knobs.

    One "hop" is item -> collection -> item; ``alpha`` is the probability
    of restarting to the origin AFTER each hop; visit probabilities are
    visit counts / n_hops with the origin's own column zeroed.
    """

    n_hops: int = 500            # walks per node (trace length)
    alpha: float = 0.85          # restart probability applied after every hop
    t_precompute: int = 100      # neighborhood size stored in the cache
    batch_walkers: int = 4096    # walkers per sweep block (one K1 launch)
    parallel_chains: int = 1     # split each origin's hop budget across this
    #                              many lockstep chains; must divide n_hops
    #                              (ops.ppr.effective_chains degrades to the
    #                              largest divisor); 1 = reference-exact chain
    sweep_blocks: int = 32       # kept for config compatibility with the
    #                              JAX package (blocks per device dispatch
    #                              there); the port launches one block at a
    #                              time
    fused_tables: bool = True    # extent-joined edge tables (the only walker
    #                              the port has; kept for compatibility)
    colisten_copies: int = 0     # materialize each TRAIN-positive pair as
    #                              this many 2-member pseudo-collections
    #                              before the PPR sweep
    #                              (data.device.augment_with_colisten)


@dataclass(frozen=True)
class PinSageConfig:
    """PinSage model shape."""

    n_layers: int = 2
    in_dim: int = 512            # node feature dim (OpenL3 -> 512)
    hidden_dim: int = 512        # neighbor aggregate dim (Q output)
    out_dim: int = 128           # conv output + final embedding dim
    T: int = 3                   # neighbors aggregated per node
    bias_init: float = 0.3       # every bias starts at 0.3


@dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (``train.trainer.PinSageTrainer``)."""

    lr: float = 1e-4
    decay: float = 0.95
    margin: float = 1e-5
    epochs: int = 30
    batch_size: int = 128
    batches_per_epoch: int = 500
    hard_negatives: bool = False
    hn_min: int = 10
    hn_max: int = 100
    hn_start_epoch: int = 0
    exact_batch_sampling: bool = False
    seed: int = 0
    checkpoint_every_batches: int = 2500
    dtype: str = "float32"       # "float32"; "bfloat16" / "float16": mixed
    # precision; "float64" trains as float32 (the JAX package without x64)
    fullgraph_forward: str = "auto"  # "auto" | "on" | "off"


@dataclass(frozen=True)
class RunConfig:
    """One full run = model + trainer + sampling config."""

    run_name: str = "pinsage_tpu"
    walk: WalkConfig = field(default_factory=WalkConfig)
    model: PinSageConfig = field(default_factory=PinSageConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        return RunConfig(
            run_name=raw.get("run_name", "pinsage_tpu"),
            walk=WalkConfig(**raw.get("walk", {})),
            model=PinSageConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
        )

    def replace(self, **kwargs: Any) -> "RunConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def recommended(run_name: str = "pinsage_tpu") -> "RunConfig":
        """The tuned defaults the JAX package recommends: co-listen
        augmentation (``walk.colisten_copies=1``), T=10 neighbors,
        margin 0.1 and lr 1e-3, easy negatives."""
        return RunConfig(
            run_name=run_name,
            walk=WalkConfig(colisten_copies=1),
            model=PinSageConfig(T=10),
            train=TrainConfig(lr=1e-3, margin=0.1),
        )


def config_with_overrides(base: RunConfig, overrides: dict[str, Any]
                          ) -> RunConfig:
    """Apply dotted-path overrides like {"train.lr": 1e-3, "model.T": 5}."""
    sections: dict[str, dict[str, Any]] = {}
    top: dict[str, Any] = {}
    for key, value in overrides.items():
        if "." in key:
            section, name = key.split(".", 1)
            sections.setdefault(section, {})[name] = value
        else:
            top[key] = value
    new = base
    for section, vals in sections.items():
        cur = getattr(new, section)
        new = new.replace(**{section: dataclasses.replace(cur, **vals)})
    if top:
        new = new.replace(**top)
    return new
