"""Deterministic, resumable synthetic LM token pipeline.

Production framing: at 1000+ nodes the data pipeline must be (a) sharded by
process with no cross-host coordination, (b) exactly resumable from a scalar
cursor carried in the checkpoint, (c) cheap enough to never be the straggler.
A counter-based generator gives all three: batch ``i`` is a pure function of
``(seed, cursor + i)``, so restart = set cursor; elastic re-sharding = rewrite
the (shard, num_shards) tuple, the global stream is unchanged.

Tokens are drawn from a Zipf-ish power-law over the vocab with a deterministic
per-position mixing hash — enough structure that cross-entropy decreases when
a model trains on it (examples/train_lm.py), while staying dependency-free.

Copied from ``src/repro/data/tokens.py`` (numpy only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline"]


def _philox(seed: int, counters: np.ndarray) -> np.ndarray:
    """Tiny counter-based RNG (splitmix64 round) → uint64 per counter."""
    x = (counters.astype(np.uint64) + np.uint64(seed * 0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x &= np.uint64(0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x &= np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class TokenPipeline:
    """Sharded, cursor-addressable synthetic token stream."""

    vocab_size: int
    seq_len: int
    global_batch: int
    shard: int = 0
    num_shards: int = 1
    seed: int = 0
    cursor: int = 0  # global step counter; checkpointed

    def __post_init__(self) -> None:
        if self.global_batch % self.num_shards != 0:
            raise ValueError("global_batch must divide evenly across shards")
        self.local_batch = self.global_batch // self.num_shards

    # ---------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {"cursor": int(self.cursor), "seed": int(self.seed)}

    def load_state_dict(self, state: dict) -> None:
        self.cursor = int(state["cursor"])
        self.seed = int(state["seed"])

    def reshard(self, shard: int, num_shards: int) -> "TokenPipeline":
        """Elastic re-sharding: same global stream under a new topology."""
        return dataclasses.replace(self, shard=shard, num_shards=num_shards, cursor=self.cursor)

    # ---------------------------------------------------------------- batch
    def next_batch(self) -> dict[str, np.ndarray]:
        batch = self.batch_at(self.cursor)
        self.cursor += 1
        return batch

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, shard): tokens + next-token labels."""
        B, T, V = self.local_batch, self.seq_len, self.vocab_size
        row0 = step * self.global_batch + self.shard * B
        rows = row0 + np.arange(B, dtype=np.int64)
        pos = np.arange(T + 1, dtype=np.int64)
        counters = rows[:, None] * np.int64(1_000_003) + pos[None, :]
        u = _philox(self.seed, counters).astype(np.float64) / float(2**64)
        # Power-law marginal: rank ~ u^alpha * V, alpha > 1 skews to low ids.
        ranks = np.minimum((u**2.2 * V).astype(np.int64), V - 1)
        # Sequence structure: mix in the previous token so bigram stats are
        # learnable (pure-iid streams give a constant-loss floor immediately).
        mixed = (ranks[:, 1:] + (ranks[:, :-1] // 7)) % V
        toks = np.concatenate([ranks[:, :1], mixed], axis=1)
        return {
            "tokens": toks[:, :T].astype(np.int32),
            "labels": toks[:, 1 : T + 1].astype(np.int32),
        }
