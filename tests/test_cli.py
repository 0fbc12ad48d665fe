"""End-to-end CLI test (round-4 verdict weak item 8): cli.main() is the
only user-facing entry point; a regression in flag wiring would otherwise
pass the whole suite. Runs the real argument parser + scene load + render
+ PNG write on the cornell box kept in tests/data, at tiny size.

Also: a forced-failure unit check of bench.py's failure-honest
aggregation."""

import json
import os

import numpy as np
import pytest


def test_cli_end_to_end(test_scene_paths, tmp_path):
    from tinyraytracing_tpu.cli import main

    out = tmp_path / "cli_render.png"
    rc = main([
        "--basedir", test_scene_paths["basedir"],
        "--xml", os.path.basename(test_scene_paths["xml"]),
        "--obj", os.path.basename(test_scene_paths["obj"]),
        "--mtl", os.path.basename(test_scene_paths["mtl"]),
        "--width", "24", "--height", "24",
        "--spp", "2", "--max-depth", "4",
        "--renderer", "queue", "--lanes", "1024",
        "--checkpoint", str(tmp_path / "snap.npz"),
        "--out", str(out),
        "--no-compile-cache",
    ])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (24, 24, 3)
    assert img.max() > 0, "rendered image is all black"


def test_cli_requires_scene_args():
    from tinyraytracing_tpu.cli import main

    with pytest.raises(SystemExit):
        main(["--spp", "2", "--no-compile-cache"])


def test_bench_aggregation_failure_honest():
    import bench

    base = {"a": 10.0, "b": 10.0}
    good = {"a": {"rays_per_s": 100.0}, "b": {"rays_per_s": 100.0}}
    rec = bench.aggregate(good, base)
    assert rec["value"] == pytest.approx(100.0)
    assert rec["vs_baseline"] == pytest.approx(10.0)
    assert rec["scenes_ok"] == ["a", "b"] and rec["scenes_failed"] == []

    # a failed scene ZEROES the headline instead of being dropped
    mixed = {"a": {"rays_per_s": 100.0},
             "b": {"rays_per_s": 0.0, "error": "device fault"}}
    rec = bench.aggregate(mixed, base)
    assert rec["value"] == 0.0
    assert rec["vs_baseline"] == 0.0
    assert rec["scenes_failed"] == ["b"]
    assert rec["scenes_ok"] == ["a"]
    json.dumps(rec)  # record stays serializable
