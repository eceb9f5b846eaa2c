"""``cli.train_vto`` over two gloo ranks on the CPU, as torchrun starts
them, with ZeRO-1 (``--shard_optimizer_states``).

Over ``test_torch_port_train_mains.write_train_tree`` with a global batch
of 2 (one row a rank), two steps with a checkpoint each; then a second
run from ``checkpoint-1`` alone, resumed to step 2: its ``unet_2.pth``
bitwise equal to the uninterrupted run's, and its step-2 loss the same.
The first step's loss within 1e-5 relative of the single process's at
batch 2 (one run of the main on ``--device cpu``).  The exports load
through the port's zoo and through the JAX zoo into a variables tree of
exactly its module's shapes.  Every rank's process gets a timeout, and a
failing or hung rank fails the test (``parallel.launch.run_ranks``).
``test_torch_port_parallel_tp_mains.py`` does the same with
``--tensor_parallel 2``.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu_torch.cli import train_vto
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.parallel.launch import run_ranks
from test_torch_port_train_mains import (
    check_unet,
    jax_shapes,
    vto_args,
    write_train_tree,
)

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 180
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(tmp_path_factory.mktemp("parallel_tree"))


def args(tree, out, steps_=2, *extra) -> list:
    argv = vto_args(tree, out, steps_=steps_) + list(extra)
    argv[argv.index("--train_batch_size") + 1] = "2"
    return argv


def run_main(tree, out, flags, steps_=2, resume=False) -> list:
    """``cli.train_vto`` on two ranks; each rank's (stdout, stderr)."""
    argv = args(tree, out, steps_, *flags)
    if resume:
        argv += ["--resume_from_checkpoint", "latest"]
    return run_ranks([sys.executable, "-m", "ladi_vton_tpu_torch.cli."
                      "train_vto", *argv], 2, timeout=TIMEOUT_S, env=ENV,
                     cwd=ROOT)


def losses(out: Path) -> list:
    return [json.loads(line)["loss"]
            for line in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def single(tree, tmp_path_factory) -> list:
    """The first step's loss of one process at the same global batch."""
    out = tmp_path_factory.mktemp("single")
    assert train_vto.main(args(tree, out, 1)) == 1
    return losses(out)


def check_two_ranks(tree, tmp_path, flags, single, monkeypatch) -> None:
    full, part = tmp_path / "full", tmp_path / "part"
    run_main(tree, full, flags)
    assert sorted(p.name for p in full.glob("checkpoint-*")) == [
        "checkpoint-1", "checkpoint-2"]
    ref = losses(full)  # written by rank 0 only: one line a step
    assert len(ref) == 2 and all(np.isfinite(ref))
    assert abs(ref[0] - single[0]) <= LOSS_RTOL * abs(single[0])
    assert (full / "imgs_step_2" / "paired").is_dir()

    part.mkdir()
    shutil.copytree(full / "checkpoint-1", part / "checkpoint-1")
    run_main(tree, part, flags, resume=True)
    assert losses(part) == ref[1:]
    a = torch.load(full / "unet_2.pth", weights_only=True)
    b = torch.load(part / "unet_2.pth", weights_only=True)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)

    # the reference layout, gathered: both zoos load it
    stock = zoo.extended_unet(checkpoint=str(full / "unet_2.pth"),
                              device="cpu").state_dict()
    assert {k: v.shape for k, v in stock.items()} == {
        k: v.shape for k, v in a.items()}
    monkeypatch.setenv("LADI_VTON_NO_CONVERT_CACHE", "1")
    module, variables, init_args = check_unet(tree, full / "unet_2.pth")
    got = {k: v.shape for k, v in flatten_dict(variables).items()}
    assert got == jax_shapes(module, *init_args)


def test_train_vto_zero1_over_two_ranks(tree, tmp_path, single,
                                        monkeypatch):
    check_two_ranks(tree, tmp_path, ["--shard_optimizer_states"], single,
                    monkeypatch)
