"""The CLI's sharding flags on the CPU (gloo ranks started by the CLI).

``render --sphere-shards 2`` writes one PNG, rank 0's, equal to the
single-process frame; ``optimize`` over a (1, 2) mesh logs the
single-process losses from rank 0 alone, and resumes from the checkpoint
rank 0 wrote (every rank reads it).  Frames are 16x9.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import load_png  # noqa: E402

SIZE = ["--builtin", "inverse64", "--width", "16", "--height", "9", "--depth", "2", "--device", "cpu"]


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_render_sphere_shards_writes_one_png(tmp_path):
    """Two gloo ranks, one PNG (rank 0's), the single-process frame."""
    assert cli.main(["render", *SIZE, "--sphere-shards", "2", "-o", str(tmp_path / "sharded.png")]) == 0
    assert cli.main(["render", *SIZE, "-o", str(tmp_path / "single.png")]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sharded.png", "single.png"]
    np.testing.assert_array_equal(load_png(tmp_path / "sharded.png"), load_png(tmp_path / "single.png"))


def test_cli_optimize_sharded_matches_single_and_resumes(tmp_path):
    """3 smooth Adam steps on one process, and on a (1, 2) mesh as 2 steps,
    a checkpoint and a resumed third: the same losses (f32, within 1e-6 of
    each: the sharded sums associate otherwise), each logged once."""
    target = tmp_path / "target.png"
    assert cli.main(["render", *SIZE, "-o", str(target)]) == 0
    opt = ["optimize", *SIZE, "--visibility", "smooth", "--target", str(target), "--lr", "1e-2"]
    assert cli.main([*opt, "--steps", "3", "--metrics", str(tmp_path / "single.jsonl")]) == 0
    ck, metrics = tmp_path / "ck.npz", tmp_path / "sharded.jsonl"
    sharded = [*opt, "--sphere-shards", "2", "--checkpoint", str(ck), "--checkpoint-every", "2",
               "--metrics", str(metrics)]
    assert cli.main([*sharded, "--steps", "2"]) == 0
    assert ck.exists()
    assert cli.main([*sharded, "--steps", "3"]) == 0
    single = [r["loss"] for r in _records(tmp_path / "single.jsonl") if r["event"] == "step"]
    recs = _records(metrics)
    steps = [r for r in recs if r["event"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    np.testing.assert_allclose([r["loss"] for r in steps], single, rtol=1e-6)
    finals = [r for r in recs if r["event"] == "optimize"]
    assert [r["steps"] for r in finals] == [2, 3] and all(r["mesh"] == [1, 2] for r in finals)
