"""The ablation path on the PyTorch port, on the CPU: the pipeline demo's
fixtures (`examples/torch_pipeline_demo.py` against
`examples/pipeline_demo.py`) and the batch-evaluation harness
(`scripts/torch_batch_evaluate.py` against `scripts/batch_evaluate.py`).

Each demo runs its own `run_demo` with its SLAM and FusionSystem replaced by
stand-ins that keep the first frames (and GPS fixes) they are given: the
ground truth texture and those frames come out of each package's own scene
code, from the same seed. The harnesses run their own `main` with the
subprocess that runs a combination replaced by a stand-in that keeps the
keyword arguments it is given and answers with set metrics: the same
directories, keyword arguments and files, byte for byte. The whole demo
and the harness run on the card (chip_smoke.py phase 2i,
doc/ABLATION_TORCH.md).
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _d in ("examples", "scripts"):
    if os.path.join(REPO, _d) not in sys.path:
        sys.path.insert(0, os.path.join(REPO, _d))

import batch_evaluate as jharness  # noqa: E402
import pipeline_demo as jdemo  # noqa: E402
import torch_batch_evaluate as tharness  # noqa: E402
import torch_pipeline_demo as tdemo  # noqa: E402
from torch_port_reference import torch_one_thread  # noqa: E402,F401

GRAY_TOL = 1e-4
N_FRAMES = 3
GPS_SIGMA = 0.5


class _Enough(Exception):
    pass


class _Slam:
    """Stands in for SLAM: keeps the frames and GPS fixes it is given and
    stops the demo after N_FRAMES."""

    def __init__(self):
        self.frames, self.gps = [], []
        self.device = torch.device("cpu")

    def track(self, img, t, gps_lla=None, gps_acc=None):
        self.frames.append(np.asarray(img, np.float32))
        self.gps.append(np.asarray(gps_lla, np.float64))
        if len(self.frames) == N_FRAMES:
            raise _Enough


class _Fusion:
    def __init__(self, *a, **k):
        pass

    def start(self):
        return self


def _scene(mod, fixture, seed, monkeypatch, tmp_path, ground_of, **kw):
    """`mod.run_demo`'s ground truth texture and first N_FRAMES frames and
    GPS fixes for `fixture` at `seed`. `ground_of` is (module, name) of the
    function that shows the ground: render_view's first argument, else
    the result (the first item of a tuple)."""
    slam, grounds = _Slam(), []
    monkeypatch.setattr(mod, "create_slam", lambda *a, **k: slam)
    monkeypatch.setattr(mod, "FusionSystem", _Fusion)
    owner, name = ground_of
    orig = getattr(owner, name)

    def keep(*a, **k):
        out = orig(*a, **k)
        grounds.append(out[0] if isinstance(out, tuple) else (
            a[0] if name == "render_view" else out))
        return out
    monkeypatch.setattr(owner, name, keep)
    with pytest.raises(_Enough):
        mod.run_demo(str(tmp_path), seed=seed, fixture=fixture,
                     gps_sigma=GPS_SIGMA, verbose=False, **kw)
    monkeypatch.undo()
    return np.asarray(grounds[0]), slam


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fixture", ["flat", "parallax", "real"])
def test_demo_fixture_matches_reference(fixture, seed, monkeypatch,
                                        tmp_path, torch_one_thread):
    """pipeline_demo.run_demo's scene of each fixture at seeds 0 and 1: the
    ground truth texture (the parallax world's true orthophoto) equal, the
    first three frames within 1e-4 gray, the GPS fixes drawn from the same
    rng in the same order equal."""
    import synth_survey
    jground_of = ((synth_survey, "true_ortho") if fixture == "parallax"
                  else (jdemo, "render_view"))
    jground, jslam = _scene(jdemo, fixture, seed, monkeypatch,
                            tmp_path / "j", jground_of)
    tground, tslam = _scene(tdemo, fixture, seed, monkeypatch,
                            tmp_path / "t", (tdemo, "fixture_scene"),
                            device="cpu")
    assert tground.dtype == jground.dtype
    np.testing.assert_array_equal(tground, jground)
    assert len(tslam.frames) == len(jslam.frames) == N_FRAMES
    for a, b in zip(tslam.frames, jslam.frames):
        assert a.shape == b.shape == (240, 320, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAY_TOL)
    for a, b in zip(tslam.gps, jslam.gps):
        np.testing.assert_array_equal(a, b)


def test_demo_rejects_an_unknown_fixture_and_defaults_to_cuda(tmp_path):
    with pytest.raises(ValueError, match="fixture"):
        tdemo.fixture_scene("hills", np.random.default_rng(0), 0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdemo.run_demo(str(tmp_path), seed=0, fixture="real",
                       gps_sigma=0.5, verbose=False)


# every axis of scripts/batch_evaluate.py:50-70, each value it tells apart
AXES = [
    [], ["SLAM.LoopClose=0"], ["SLAM.LoopClose=1"], ["SLAM.LoopClose=false"],
    ["SLAM.nFeature=400"], ["fixture=parallax"], ["seed=3"],
    ["gps=0.5"], ["gps=0"], ["gps=off"], ["refresh=1"], ["refresh=0"],
    ["refresh=off"], ["Tracker=opt"], ["Map2D.Type=4"],
    ["fixture=flat,real", "gps=0.5", "refresh=1,0", "seed=0,1"],
]


def _metrics(combo):
    """Set metrics a combination answers with: seed-dependent, some runs
    failing (no metrics line) so that the aggregate skips them."""
    d = dict(combo)
    if d.get("fixture") == "real" and d.get("refresh") == "0" \
            and d.get("seed") == "1":
        return None
    s = int(d.get("seed", 0))
    return {"frames": 52, "tracked_ratio": 0.9 + 0.01 * s,
            "ate_pct": 3.0 + 0.7 * s, "psnr": 0.0 if d.get("refresh") == "0"
            else 14.0 - 0.3 * s, "points": 1100 + 13 * s,
            "keyframes": 38 + s, "wall_s": 30.0 + s}


def _harness_run(mod, axes, out, monkeypatch):
    """`mod.main` over `axes` with its combination subprocess replaced:
    (exit code, [(argv's combination, its kwargs)], {path: bytes})."""
    calls = []

    def fake_run(argv, **kw):
        combo, kwargs = json.loads(argv[-2]), json.loads(argv[-1])
        calls.append((combo, kwargs))
        m = _metrics(combo.items())
        return SimpleNamespace(returncode=0, stdout="" if m is None
                               else "METRICS " + json.dumps(m) + "\n")
    monkeypatch.setattr(mod.subprocess, "run", fake_run)
    rc = mod.main([str(out), *axes])
    monkeypatch.undo()
    files = {}
    for d, _, names in os.walk(out):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, out)] = f.read()
    return rc, calls, files


@pytest.mark.parametrize("axes", AXES,
                         ids=["_".join(a) or "default" for a in AXES])
def test_harness_maps_axes_as_reference(axes, tmp_path, monkeypatch,
                                        capsys):
    """Both harnesses over the same axes: the same combinations, each with
    the same run_demo keyword arguments, and the same files (stdout.log,
    metrics.json, summary.json, aggregate.json) byte for byte; the port's
    harness exits 1 where a combination failed."""
    jrc, jcalls, jfiles = _harness_run(jharness, axes, tmp_path / "j",
                                       monkeypatch)
    trc, tcalls, tfiles = _harness_run(tharness, axes, tmp_path / "t",
                                       monkeypatch)
    assert tcalls == jcalls
    for combo, kwargs in tcalls:
        assert tharness.combo_kwargs(list(combo.items())) == kwargs
    assert sorted(tfiles) == sorted(jfiles)
    assert all(tfiles[k] == jfiles[k] for k in jfiles)
    failed = any(_metrics(c.items()) is None for c, _ in tcalls)
    assert jrc == 0 and trc == (1 if failed else 0)
    if failed:
        assert "FAILED" in capsys.readouterr().out


def test_aggregate_matches_reference(tmp_path):
    """aggregate.json from the same results, byte for byte: runs grouped
    over their seeds, failed runs (None) left out."""
    results = {}
    for fixture in ("flat", "real"):
        for refresh in ("1", "0"):
            for seed in ("0", "1", "2"):
                name = f"fixture-{fixture}_refresh-{refresh}_seed-{seed}"
                results[name] = _metrics([("fixture", fixture),
                                          ("refresh", refresh),
                                          ("seed", seed)])
    results["seed-4"] = _metrics([("seed", "4")])
    results["gps-0.5"] = _metrics([])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jharness._aggregate_over_seeds(str(tmp_path / "j"), results)
    tharness.write_aggregate(str(tmp_path / "t"), results)
    j = (tmp_path / "j" / "aggregate.json").read_bytes()
    assert (tmp_path / "t" / "aggregate.json").read_bytes() == j
    agg = json.loads(j)
    assert agg["fixture-real_refresh-0"]["n_runs"] == 2
    assert agg["default"]["n_runs"] == 1


def test_harness_fails_a_run_that_exits_nonzero(tmp_path, monkeypatch):
    """A combination whose process exits nonzero fails even when it printed
    metrics: FAILED, metrics null, exit 1."""
    monkeypatch.setattr(tharness.subprocess, "run", lambda *a, **k:
                        SimpleNamespace(returncode=1, stdout="METRICS "
                                        + json.dumps(_metrics([])) + "\n"))
    assert tharness.main([str(tmp_path), "seed=0"]) == 1
    assert json.loads((tmp_path / "seed-0" / "metrics.json").read_text()) \
        is None
