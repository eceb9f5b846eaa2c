"""``cli.inference`` over two gloo ranks on the CPU against one process,
and the four-phase ``parallel.dryrun.dryrun_multichip(4)``.

The inference main runs over ``test_torch_port_cli``'s tiny tree and
VITON-HD split of 3 pairs at batch 2 (the last batch padded with a
repeat), as torchrun starts two ranks: data 2 (one row of each batch a
rank, each row with its row of the global batch's noise) and data 1 x
model 2 (``--tensor_parallel 2``, the UNet split over the ranks).  The
saved PNGs are the one process's, each within one level of 255: the
ranks sum the same fp32 products over other batch and head groupings.
Every item is saved once.  The dry run starts its own four ranks.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ladi_vton_tpu_torch.cli import inference as inference_cli
from ladi_vton_tpu_torch.parallel import dryrun
from ladi_vton_tpu_torch.parallel.dryrun import dryrun_multichip
from ladi_vton_tpu_torch.parallel.launch import run_ranks
from test_torch_port_cli import _common, data, tree  # noqa: F401 - fixtures
from test_torch_port_parallel_mains import ENV, ROOT, TIMEOUT_S

LEVELS = 1


def argv(tree, data, out) -> list:
    return _common(data, "vitonhd", out) + [
        "--checkpoint_dir", str(tree / "ladi"),
        "--sd2_model_dir", str(tree / "sd2"),
        "--clip_vision_dir", str(tree / "clip_vision"), "--use_png"]


def pngs(root: Path) -> dict:
    return {p.relative_to(root): np.asarray(Image.open(p), np.int16)
            for p in sorted(root.rglob("*.png"))}


@pytest.fixture(scope="module")
def single(tree, data, tmp_path_factory):
    out = tmp_path_factory.mktemp("single")
    assert inference_cli.main(argv(tree, data, out))["images"] == 3
    return pngs(out)


@pytest.mark.parametrize("flags", [[], ["--tensor_parallel", "2"]],
                         ids=["data2", "model2"])
def test_inference_over_two_ranks_equals_one_process(tree, data, single,
                                                     flags, tmp_path):
    run_ranks([sys.executable, "-m", "ladi_vton_tpu_torch.cli.inference",
               *argv(tree, data, tmp_path), *flags], 2, timeout=TIMEOUT_S,
              env=ENV, cwd=ROOT)
    got = pngs(tmp_path)
    assert sorted(got) == sorted(single) and len(got) == 3
    for name, img in single.items():
        assert np.abs(got[name] - img).max() <= LEVELS, name


def test_dryrun_multichip_four_ranks():
    results = dryrun_multichip(4, "cpu", timeout=TIMEOUT_S)
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    # one loss on every rank; the AdamW state split four ways
    assert len({r["loss1"] for r in results}) == 1
    assert sum(r["adam_numel"] for r in results) == \
        2 * results[0]["param_numel"]
    assert all(np.isfinite([r["loss2"], r["loss4"]]).all() for r in results)


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    # the default device is the card: with none, both entry points raise
    # before any rank starts
    def no_spawn(*args, **kw):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("ladi_vton_tpu_torch.parallel.launch.spawn", no_spawn)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--ranks", "2"])
