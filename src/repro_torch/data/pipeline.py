"""Deterministic sharded data pipeline with prefetch and exact resume.

Shards are synthetic (seeded by (seed, shard_index)) — the pool brief stubs
modality frontends, and training examples need reproducible token streams.
The pipeline state (next shard index) is part of the checkpoint, so restart
resumes the stream exactly. A background prefetch thread hides generation
latency (the straggler-mitigation analog at the input layer). (The port's
copy of ``repro/data/pipeline.py``: batches are numpy arrays, which the
port's trainer moves to its device.)
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineState:
    next_shard: int = 0
    epoch: int = 0


class ShardedTokenPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        global_batch: int,
        seq_len: int,
        num_shards: int = 1024,
        seed: int = 0,
        prefetch: int = 2,
        state: PipelineState | None = None,
    ):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.num_shards = num_shards
        self.seed = seed
        self.state = state or PipelineState()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- generation
    def _gen(self, shard: int, epoch: int) -> dict:
        """Synthetic but *learnable* stream: with prob 0.8 the next token
        follows a fixed affine bigram rule, else it's uniform noise. A model
        that learns the rule reaches ~0.2*log V + H(0.8) nats, well below the
        uniform-entropy floor — so training-loss assertions mean something."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, shard])
        )
        b, s = self.global_batch, self.seq_len
        v = self.cfg.vocab_size
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        noise = rng.random((b, s)) < 0.2
        randoms = rng.integers(0, v, size=(b, s), dtype=np.int32)
        for t in range(1, s + 1):
            rule = (toks[:, t - 1] * 7 + 13) % v
            toks[:, t] = np.where(noise[:, t - 1], randoms[:, t - 1], rule)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.is_vlm:
            batch["vision"] = rng.standard_normal(
                (b, self.cfg.num_vision_tokens, self.cfg.d_model), dtype=np.float32
            )
        if self.cfg.is_enc_dec:
            batch["frames"] = rng.standard_normal(
                (b, self.cfg.num_frames, self.cfg.d_model), dtype=np.float32
            )
        return batch

    # --------------------------------------------------------------- prefetch
    def _worker(self):
        st = PipelineState(self.state.next_shard, self.state.epoch)
        while not self._stop.is_set():
            batch = self._gen(st.next_shard, st.epoch)
            meta = PipelineState(st.next_shard, st.epoch)
            st.next_shard += 1
            if st.next_shard >= self.num_shards:
                st.next_shard = 0
                st.epoch += 1
            while not self._stop.is_set():
                try:
                    self._q.put((meta, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __next__(self) -> dict:
        if self._thread is None:
            batch = self._gen(self.state.next_shard, self.state.epoch)
            self._advance()
            return batch
        meta, batch = self._q.get()
        # consumed shard `meta`; the resume point is the one after it
        self.state = PipelineState(meta.next_shard, meta.epoch)
        self._advance()
        return batch

    def _advance(self):
        ns = self.state.next_shard + 1
        ep = self.state.epoch
        if ns >= self.num_shards:
            ns, ep = 0, ep + 1
        self.state = PipelineState(ns, ep)

    def __iter__(self):
        return self

    # ----------------------------------------------------------------- resume
    def state_dict(self) -> dict:
        return {"next_shard": self.state.next_shard, "epoch": self.state.epoch}

    def load_state_dict(self, d: dict):
        self.stop()
        self.state = PipelineState(int(d["next_shard"]), int(d["epoch"]))
