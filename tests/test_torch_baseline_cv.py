"""The port's constant-velocity baseline (``python -m
desire_tpu_torch.baseline_cv``) against the repository's
``scripts/baseline_cv.py`` (loaded from its path, unedited) on
tests/test_torch_data.py's split tree: the same JSON line on every split,
with and without speed bins (5,15, where every agent of the tree is
slower than 5 px a step, and 1.4, which splits them)."""

import importlib.util
import json
import os

import pytest

from desire_tpu_torch import baseline_cv
from test_torch_data import split_tree  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "scripts_baseline_cv", os.path.join(ROOT, "scripts", "baseline_cv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line(main, argv, capsys):
    main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def _approx(x):
    if isinstance(x, dict):
        return {k: _approx(v) for k, v in x.items()}
    return pytest.approx(x, rel=1e-12) if isinstance(x, float) else x


@pytest.mark.parametrize("bins", ["", "5,15", "1.4"])
@pytest.mark.parametrize("split", ["heldout", "train", "all"])
def test_baseline_matches_the_jax_script(  # noqa: F811
        split_tree, capsys, split, bins):
    argv = ["--data_dir", split_tree, "--obs_len", "3", "--pred_len", "2",
            "--subsample", "1", "--max_num_obj", "4", "--window_hop", "1",
            "--eval_hop", "2", "--batch_size", "2", "--split", split]
    if bins:
        argv += ["--speed_bins", bins]
    want = _line(_jax_script().main, argv, capsys)
    got = _line(baseline_cv.main, argv, capsys)
    assert want["num_agents"] > 0
    assert set(got) == set(want)
    assert got == _approx(want)
    if bins:
        assert len(got["speed_classes"]) == len(bins.split(",")) + 1
