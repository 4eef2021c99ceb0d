"""Token data pipeline: deterministic, per-host sharded, resumable.

A copy of ``repro/data/pipeline.py`` (pure numpy, so the batches are
byte-identical to the reference's) without JAX: a host's rank and the host
count default to the ``torch.distributed`` process group's, or 0 and 1
when there is none.  ``MultimodalPipeline`` adds the multimodal families'
modality stream (patch embeddings or source frames).

- **Per-host sharding**: each host reads only its slice of the global batch
  (``host_id / n_hosts``); the arrays produced are the *local* shard.
- **Exactly-once accounting**: the pipeline state is a (epoch, step,
  rng-counter) triple, checkpointed alongside the model so restarts resume
  mid-epoch without repeating or skipping samples.
- **Deterministic & host-count invariant**: sample content is a pure
  function of (seed, epoch, step) at *global-batch* granularity — each
  host materialises the global batch's token draw and slices its share,
  so an elastic re-mesh that changes the host count (straggler eviction,
  pool join) resumes the identical global sample stream.  ``reshard``
  re-slices a live pipeline onto a new (host_id, n_hosts) without
  touching its position.

Sources: synthetic LM tokens (zipf-ish unigram draw — keeps the loss
non-degenerate) or a memory-mapped binary token file.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    step: int = 0          # steps consumed within the epoch
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(**{k: int(v) for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class DataCfg:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    source: str = "synthetic"        # "synthetic" | "tokens_file"
    path: str | None = None
    steps_per_epoch: int = 1 << 30   # synthetic = unbounded epochs


class TokenPipeline:
    """Iterator of {'tokens': (local_batch, seq+?) int32} batches."""

    def __init__(self, cfg: DataCfg, *, host_id: int | None = None,
                 n_hosts: int | None = None,
                 state: PipelineState | None = None):
        self.cfg = cfg
        live = dist.is_available() and dist.is_initialized()
        if host_id is None:
            host_id = dist.get_rank() if live else 0
        if n_hosts is None:
            n_hosts = dist.get_world_size() if live else 1
        self.host_id, self.n_hosts = host_id, n_hosts
        if cfg.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide over hosts")
        self.local_batch = cfg.global_batch // self.n_hosts
        self.state = state or PipelineState(seed=cfg.seed)
        self._mmap = None
        if cfg.source == "tokens_file":
            if not cfg.path or not os.path.exists(cfg.path):
                raise FileNotFoundError(cfg.path)
            self._mmap = np.memmap(cfg.path, dtype=np.int32, mode="r")

    # --- deterministic content ---
    def _synthetic(self, epoch: int, step: int) -> np.ndarray:
        # content is seeded per GLOBAL batch row, so the stream survives an
        # elastic host-count change byte-identically (seeding per
        # (step, host) would re-deal every sample on re-mesh) while each
        # host only draws its own O(local_batch) rows
        B, S, V = self.local_batch, self.cfg.seq_len, self.cfg.vocab
        lo = self.host_id * B
        u = np.stack([
            np.random.default_rng(
                (self.state.seed, epoch, step, row)).random(S)
            for row in range(lo, lo + B)])
        # zipf-ish unigram over the vocab: learnable structure, finite loss
        return np.minimum((V ** u - 1.0), V - 1).astype(np.int32)

    def _from_file(self, epoch: int, step: int) -> np.ndarray:
        B, S = self.local_batch, self.cfg.seq_len
        n_tokens = self._mmap.shape[0]
        n_seqs = n_tokens // S
        rng = np.random.default_rng(self.state.seed + epoch)
        order = rng.permutation(n_seqs)
        base = (step * self.cfg.global_batch + self.host_id * B) % n_seqs
        idx = order[(base + np.arange(B)) % n_seqs]
        return np.stack([self._mmap[i * S:(i + 1) * S] for i in idx]) \
            .astype(np.int32)

    # --- iteration ---
    def next_batch(self) -> dict:
        st = self.state
        if self.cfg.source == "synthetic":
            toks = self._synthetic(st.epoch, st.step)
        else:
            toks = self._from_file(st.epoch, st.step)
        st.step += 1
        if st.step >= self.cfg.steps_per_epoch:
            st.epoch, st.step = st.epoch + 1, 0
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    # --- elastic re-sharding ---
    def reshard(self, *, host_id: int, n_hosts: int) -> "TokenPipeline":
        """The same stream re-sliced for a new host layout (same position).

        After straggler eviction the surviving hosts re-divide the
        *unchanged* global batch; because content is drawn at global
        granularity, the concatenation of all hosts' shards is identical
        before and after — exactly-once holds across the re-mesh.
        """
        return TokenPipeline(self.cfg, host_id=host_id, n_hosts=n_hosts,
                             state=PipelineState(**self.state.to_dict()))

    # --- checkpoint integration ---
    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)


class MultimodalPipeline(TokenPipeline):
    """TokenPipeline plus a synthetic modality stream (M6 workloads).

    The vision/audio frontends are STUBS (see
    :mod:`repro_torch.models.frontends`): real towers would emit
    precomputed embeddings, so the pipeline synthesises them — unit-normal
    ``patch_embeds`` (B, frontend_len, d_model) for ``vlm`` or ``frames``
    (B, src_len, d_model) for ``encdec`` — with the same per-global-row
    seeding discipline as the token draw, so the stream stays
    deterministic, resumable, and host-count invariant under
    :meth:`reshard`.
    """

    def __init__(self, cfg: DataCfg, *, modality: str, d_model: int,
                 frontend_len: int = 0, src_len: int = 0,
                 host_id: int | None = None, n_hosts: int | None = None,
                 state: PipelineState | None = None):
        if modality not in ("vlm", "encdec"):
            raise ValueError(f"modality must be 'vlm' or 'encdec', "
                             f"got {modality!r}")
        if modality == "vlm" and frontend_len <= 0:
            raise ValueError("vlm needs frontend_len > 0 patch positions")
        if modality == "encdec" and src_len <= 0:
            raise ValueError("encdec needs src_len > 0 source frames")
        super().__init__(cfg, host_id=host_id, n_hosts=n_hosts, state=state)
        self.modality = modality
        self.d_model = d_model
        self.frontend_len = frontend_len
        self.src_len = src_len

    def _embeds(self, epoch: int, step: int, length: int) -> np.ndarray:
        # 7919 (the 1000th prime) offsets the stream id so modality rows
        # never collide with the token rows' (seed, epoch, step, row) keys
        B = self.local_batch
        lo = self.host_id * B
        return np.stack([
            np.random.default_rng((self.state.seed, epoch, step, 7919, row))
            .standard_normal((length, self.d_model))
            for row in range(lo, lo + B)]).astype(np.float32)

    def next_batch(self) -> dict:
        epoch, step = self.state.epoch, self.state.step
        batch = super().next_batch()          # advances the state
        if self.modality == "vlm":
            batch["patch_embeds"] = self._embeds(epoch, step,
                                                 self.frontend_len)
        else:
            batch["frames"] = self._embeds(epoch, step, self.src_len)
        return batch

    def reshard(self, *, host_id: int, n_hosts: int) -> "MultimodalPipeline":
        return MultimodalPipeline(
            self.cfg, modality=self.modality, d_model=self.d_model,
            frontend_len=self.frontend_len, src_len=self.src_len,
            host_id=host_id, n_hosts=n_hosts,
            state=PipelineState(**self.state.to_dict()))


def write_token_file(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)
