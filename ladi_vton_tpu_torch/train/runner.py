"""What the four trainers share: logging, trackers, validation policy and
the step loop with checkpoints and resume.

Counterpart of ``ladi_vton_tpu/train/runner.py``.  ``Trackers`` always
appends one JSON line per logged step to ``<output_dir>/metrics.jsonl``,
and adds tensorboard and wandb only where they import; image grids are
written as PNGs by the port's own writer.  ``train_loop`` draws each
step's randomness from ``core.rng.batch_generator(seed, step)``, so a
step's draws depend only on the seed and its index, and positions the
loader at the step it starts from (``BatchLoader.start_at``): a resumed
run reads the same batches and draws as an uninterrupted one.

Over a mesh (``core.mesh``) the loader still yields the global batch in
the JAX order; each rank takes its rows along ``data``, and the draws are
made for the global batch and cut to the same rows, so W ranks see the
single process's batches, noise and timesteps.  The state is gathered on
every rank (ZeRO-1's consolidation and tensor parallelism's gathers are
collective) and saved by rank 0; logs and trackers are rank 0's; every
rank waits at a barrier after a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ladi_vton_tpu_torch.core.distributed import barrier, is_main_process
from ladi_vton_tpu_torch.core.mesh import Mesh, shard_batch
from ladi_vton_tpu_torch.core.rng import batch_generator
from ladi_vton_tpu_torch.data import imageio


def setup_logging(output_dir, name: str = "ladi_vton_tpu_torch"):
    """Python logging as the reference's trainers set it up."""
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)
    return logging.getLogger(name)


class Trackers:
    """wandb / tensorboard when importable, and a local jsonl always."""

    def __init__(self, report_to: Optional[str], project: str, output_dir,
                 config: dict, entity: Optional[str] = None):
        self.backends = []
        if report_to in ("wandb", "all"):
            try:
                import wandb

                wandb.init(project=project, entity=entity, config=config,
                           dir=str(output_dir))
                self.backends.append(("wandb", wandb))
            except Exception as e:  # noqa: BLE001 - optional tracker
                print(f"wandb unavailable ({e}); logging to jsonl")
        if report_to in ("tensorboard", "all"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.backends.append(
                    ("tb", SummaryWriter(log_dir=str(output_dir))))
            except Exception as e:  # noqa: BLE001 - optional tracker
                print(f"tensorboard unavailable ({e})")
        self._jsonl = open(Path(output_dir) / "metrics.jsonl", "a")
        self.backends.append(("jsonl", self._jsonl))

    def log(self, metrics: dict, step: int) -> None:
        for kind, backend in self.backends:
            if kind == "wandb":
                backend.log(metrics, step=step)
            elif kind == "tb":
                for k, v in metrics.items():
                    backend.add_scalar(k, v, step)
            else:
                backend.write(json.dumps({"step": step, **metrics}) + "\n")
                backend.flush()

    def log_images(self, tag: str, images, step: int, output_dir=None):
        """NHWC images in [0, 1]: to wandb/tensorboard where live, and up
        to eight PNGs under ``<output_dir>/samples``."""
        arr = np.asarray(images)
        for kind, backend in self.backends:
            if kind == "wandb":
                backend.log({tag: [backend.Image(a) for a in arr]},
                            step=step)
            elif kind == "tb":
                backend.add_images(tag, arr.transpose(0, 3, 1, 2), step)
        if output_dir:
            grid_dir = Path(output_dir) / "samples"
            grid_dir.mkdir(parents=True, exist_ok=True)
            for i, a in enumerate(arr[:8]):
                imageio.write_png(
                    grid_dir / f"{tag.replace('/', '_')}_{step}_{i}.png",
                    np.round(np.clip(a, 0, 1) * 255).astype(np.uint8), "RGB")

    def finish(self) -> None:
        for kind, backend in self.backends:
            if kind == "wandb":
                backend.finish()
            else:
                backend.close()


class NullTrackers:
    """The trackers of a rank that is not the main process: no output."""

    def log(self, metrics: dict, step: int) -> None:
        pass

    def log_images(self, tag: str, images, step: int, output_dir=None):
        pass

    def finish(self) -> None:
        pass


def make_trackers(*args, **kwargs):
    """``Trackers`` on the main process, ``NullTrackers`` on the others."""
    return Trackers(*args, **kwargs) if is_main_process() else NullTrackers()


def run_checkpoint_validation(fn: Callable, step: int, logger) -> None:
    """Run a checkpoint-time validation, tolerating only a missing
    artifact (``FileNotFoundError``: metric weights or caches absent);
    every other error raises."""
    try:
        fn()
    except FileNotFoundError as e:
        logger.info(f"validation at step {step} skipped (missing "
                    f"artifact): {e}")


@dataclasses.dataclass
class LoopConfig:
    max_train_steps: int
    checkpointing_steps: int = 50000
    # every step's metrics (the JAX loop logs every 50 to spare the TPU
    # host syncs; an eager step ends in one anyway)
    log_every: int = 1
    seed: int = 1234


def train_loop(*, step_fn: Callable, loader, to_batch: Callable,
               device, ckpt_manager, state_fn: Callable, loop: LoopConfig,
               logger, trackers: Trackers,
               draws_fn: Optional[Callable] = None, start_step: int = 0,
               on_checkpoint: Optional[Callable] = None,
               mesh: Optional[Mesh] = None) -> int:
    """Train from ``start_step`` to ``loop.max_train_steps``.

    Each step: ``to_batch`` of this rank's rows of the loader's batch, the
    draws ``draws_fn(batch, batch_generator(seed, step, device))`` of the
    global batch cut to those rows (none without ``draws_fn``; a draws
    function reads only the batch's ``image`` shape),
    ``step_fn(batch, draws)``.  The trainers' ``step_fn`` is a
    ``pipelines.graphs.TrainProgram``: it writes the step's learning rate,
    replays the captured step (the first step of a batch shape runs
    eagerly, then captures) and advances the optimizer's count.  A replay
    runs on the caller's current stream, so the checkpoints and
    ``on_checkpoint`` read the parameters and the optimizer state after
    it, in order.  Every ``log_every`` steps the metrics go
    to the trackers; every ``checkpointing_steps`` the state
    ``state_fn(step)`` (collective, None off the main process) is saved
    by the main process and ``on_checkpoint(step)`` runs on every rank;
    the last step is saved too.  Returns the final step."""
    main = is_main_process()

    def save(step: int) -> None:
        state = state_fn(step)
        if main:
            ckpt_manager.save(step, state)
            logger.info(f"saved checkpoint-{step}")

    n = len(loader)
    if n == 0:
        raise ValueError("the train split holds fewer items than a batch")
    loader.start_at(start_step // n, start_step % n)
    step = start_step
    t_last = time.perf_counter()
    while step < loop.max_train_steps:
        for raw in loader:
            if step >= loop.max_train_steps:
                break
            rows = (mesh.rows(len(raw["image"])) if mesh is not None
                    else slice(None))
            batch = to_batch(shard_batch(mesh, raw))
            draws = None
            if draws_fn is not None:
                draws = draws_fn({"image": raw["image"]},
                                 batch_generator(loop.seed, step, device))
                draws = {k: v[rows] for k, v in draws.items()}
            metrics = step_fn(batch, draws)
            step += 1
            if step % loop.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                metrics["steps_per_sec"] = loop.log_every / (now - t_last)
                t_last = now
                if main:
                    logger.info(f"step {step}: {metrics}")
                    trackers.log(metrics, step)
            if step % loop.checkpointing_steps == 0:
                save(step)
                if on_checkpoint is not None:
                    on_checkpoint(step)
                barrier()
                t_last = time.perf_counter()  # time steps, not the saves
    if step > start_step and step % loop.checkpointing_steps != 0:
        save(step)
    if main:
        ckpt_manager.wait()
    barrier()
    return step
