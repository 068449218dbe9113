"""Fault-tolerant training loop (the port of ``repro/train/trainer.py``).

Production behaviors implemented (and tested with injected failures):
  * periodic async checkpoints (params + optimizer + data-pipeline state);
  * crash/restart: on failure the loop restores the newest committed
    checkpoint — including the exact pipeline position — and continues;
  * step-time watchdog: steps slower than ``straggler_factor`` x the running
    median are logged as straggler events (at fleet scale these feed the
    scheduler; here they feed metrics);
  * an ``on_checkpoint`` hook after each committed save (the reference
    replicates checkpoints across regions there; that path is not ported);
  * an optional gradient transform (e.g. int8 compression).

It runs on the card unless given another ``device``: fresh parameters
come from a ``torch.Generator`` on that device seeded with
``TrainerConfig.seed``, and each numpy batch of the pipeline is moved
there. The step runs eagerly and updates the state in place.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.sharding.specs import ShardingRules
from .optimizer import OptConfig, init_opt_state
from .train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 25
    ckpt_dir: str = "artifacts/ckpt"
    keep_ckpts: int = 3
    seed: int = 0
    microbatches: int = 1
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        *,
        rules: ShardingRules | None = None,
        opt_cfg: OptConfig | None = None,
        grad_transform: Callable | None = None,
        failure_injector: Callable[[int], bool] | None = None,
        on_checkpoint: Callable[[Path, int], None] | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.rules = rules or ShardingRules(batch=None, fsdp=None, tp=None)
        self.opt_cfg = opt_cfg or OptConfig(total_steps=tcfg.steps)
        self.failure_injector = failure_injector
        self.on_checkpoint = on_checkpoint
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        self.pipeline = ShardedTokenPipeline(
            cfg, global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
            seed=tcfg.seed,
        )
        self._step = make_train_step(
            cfg, self.rules, self.opt_cfg,
            microbatches=tcfg.microbatches, grad_transform=grad_transform,
        )
        self.metrics_log: list[dict] = []
        self.restarts = 0
        self.straggler_events = 0

    # ------------------------------------------------------------- lifecycle
    def _fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, self.device)
        return params, init_opt_state(params)

    def _restore_or_init(self):
        params, opt_state = self._fresh_state()
        tree = {"params": params, "opt": opt_state}
        restored, step, extra = self.ckpt.restore(tree)
        if restored is None:
            return params, opt_state, 0
        if "pipeline" in extra:
            self.pipeline.load_state_dict(extra["pipeline"])
        return restored["params"], restored["opt"], step

    def _batch(self) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in next(self.pipeline).items()}

    # ------------------------------------------------------------------ loop
    def run(self) -> dict:
        params, opt_state, start = self._restore_or_init()
        step = start
        times: list[float] = []
        while step < self.tcfg.steps:
            try:
                batch = self._batch()
                if self.failure_injector and self.failure_injector(step):
                    raise RuntimeError(f"injected node failure at step {step}")
                t0 = time.time()
                params, opt_state, metrics = self._step(params, opt_state,
                                                        batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                times.append(dt)
                med = float(np.median(times[-50:]))
                if len(times) > 5 and dt > self.tcfg.straggler_factor * med:
                    self.straggler_events += 1
                    metrics["straggler"] = dt / med
                step += 1
                metrics["step"] = step
                metrics["step_time_s"] = dt
                if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                    self.metrics_log.append(metrics)
                if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                    self.ckpt.save_async(
                        step,
                        {"params": params, "opt": opt_state},
                        extra={"pipeline": self.pipeline.state_dict()},
                    )
                    if self.on_checkpoint:
                        self.ckpt.wait()
                        path = self.ckpt.latest()
                        if path is not None:
                            self.on_checkpoint(path, step)
            except RuntimeError as ex:
                if "injected node failure" not in str(ex):
                    raise
                # ---- restart path: restore last committed state
                self.restarts += 1
                self.ckpt.wait()
                params, opt_state, step = self._restore_or_init()
        self.ckpt.wait()
        return {
            "final_step": step,
            "restarts": self.restarts,
            "straggler_events": self.straggler_events,
            "losses": [m["loss"] for m in self.metrics_log],
            "metrics": self.metrics_log,
        }
