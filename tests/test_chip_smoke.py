"""chip_smoke.py on the CPU: its phases at tiny synthetic geometry, its gates
and helpers, and its refusal to report success without a GPU.  Also the
stills asset it loads and the compile-cache placement it sets up."""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
from collections import namedtuple

import numpy as np
import pytest

import jax

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lane_tracker_tpu.calib.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    tiny_config,
)
from lane_tracker_tpu.parallel.pipeline import build_chunk_processor  # noqa: E402
from lane_tracker_tpu.tracker.config import PRESETS  # noqa: E402
from lane_tracker_tpu.tracker.step import make_initial_state  # noqa: E402


def _lane_frames(warp, n, seed=0):
    """Camera frames whose bird's-eye view holds two straight lanes at
    38% and 62% of the warped width, shifting slightly frame to frame."""
    W, H = warp.image_width_height
    Ww, Hw = warp.warped_width_height
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    p = np.tensordot(np.asarray(warp.M), np.stack([u, v, np.ones_like(u)]),
                     1)
    road = np.sign(p[2]) == np.sign(p[2][-1, W // 2])  # below the horizon
    x, y = p[0] / p[2], p[1] / p[2]
    frames = np.random.default_rng(seed).integers(
        20, 60, (n, H, W, 3)).astype(np.uint8)
    for t in range(n):
        shift = 1.5 * np.sin(t)
        lanes = road & (y > 0) & (y < Hw) & (
            (np.abs(x - (0.38 * Ww + shift)) < 3)
            | (np.abs(x - (0.62 * Ww + shift)) < 3))
        frames[t][lanes] = 230
    return frames


def _oracle(dep, content):
    """The 'fast' pipeline's own trace, standing in for the live
    reference's at tiny geometry."""
    params = cs.build_params(dep, "fast")
    fail_every = {"stills": 0, "fail16": 16}[content]
    chunk = cs.stills_chunk(dep, dep.T, fail_every)
    fn = build_chunk_processor(dep.config, with_overlay=False,
                               second_attempt="two_phase")
    _, o = fn(make_initial_state(dep.config, params.warped_size), chunk,
              params)
    return {"valid": np.asarray(o.valid), "left": np.asarray(o.left_coeffs),
            "right": np.asarray(o.right_coeffs)}


def _with_oracles(dep):
    return dataclasses.replace(
        dep, oracles={c: _oracle(dep, c) for c in ("stills", "fail16")})


@pytest.fixture(scope="module")
def tiny():
    cam, warp = make_synthetic_calibration(img_size=(128, 96),
                                           warped_size=(96, 128))
    dep = cs.Deployment(cam, warp, tiny_config(), _lane_frames(warp, 4), {},
                        T=8, fleet_T=4, col_roi=(8, 88))
    return _with_oracles(dep)


PHASES = {
    "pair": lambda d: (cs.phase_pair, (d,)),
    "stages": lambda d: (cs.phase_stages, (d,)),
    "stills_corridor": lambda d: (cs.phase_chunk, (d, "corridor", "stills",
                                                   {})),
    "fail16_fast": lambda d: (cs.phase_chunk, (d, "fast", "fail16", {})),
    "fleet_two_phase": lambda d: (cs.phase_fleet, (d, "two_phase")),
    "cli": lambda d: (cs.phase_cli, (_with_oracles(
        dataclasses.replace(d, config=PRESETS["demo1"])),)),
    "card_tests": lambda d: (cs.phase_card_tests, (False,)),
}


@pytest.mark.parametrize("name", list(PHASES))
def test_phase_runs_at_tiny_geometry(tiny, name, capsys):
    fn, args = PHASES[name](tiny)
    info = cs.run_phase(name, fn, *args)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"phase {name}: compile_s=")
    assert "run_s=" in line and "peak_bytes_in_use=" in line
    if name.startswith(("stills", "fail16")):
        assert info["trace_mismatches"] == 0
    if name == "fail16_fast":
        assert info["second_attempts"] > 0


def test_four_phases_select_only_the_sharded_fleet(tiny):
    four = cs.four_phases(tiny)
    assert [n for n, _, _ in four] == ["fleet4_two_phase", "fleet4_hoist"]
    for _, fn, args in four:
        assert fn is cs.phase_fleet
        dep, schedule, n_streams, T, dead, mesh = args
        assert (n_streams, T, dead) == (8, 32, 3)
        assert mesh.shape["stream"] == 4
    names = [n for n, _, _ in cs.default_phases(tiny)]
    assert names == ["pair", "stages", "stills_corridor", "stills_fast",
                     "fail16_corridor", "fail16_fast", "fleet_two_phase",
                     "fleet_hoist", "cli"]


def test_four_phase_shards_over_four_devices(tiny):
    """The --four path on four virtual CPU devices (at T=4): shards on
    four distinct devices, parity with the unsharded replay."""
    assert len(jax.devices()) >= 4
    _, fn, args = cs.four_phases(tiny)[0]
    dep, schedule, n_streams, _, dead, mesh = args
    info = fn(dep, schedule, n_streams, 4, dead, mesh)
    assert info["devices"] == 4 and info["frames"] == n_streams * 4


Outs = namedtuple("Outs", "valid left_coeffs right_coeffs n_attempts "
                          "corridor_ok")


def _outs(valid, shift=0.0, ok=True):
    n = len(valid)
    left = np.tile([0.0, 0.0, 100.0 + shift], (n, 1))
    right = np.tile([0.0, 0.0, 300.0], (n, 1))
    return Outs(np.asarray(valid), left, right, np.ones(n, np.int32),
                np.full(n, ok))


ORACLE = {"valid": np.array([True, True, False, True]),
          "left": np.tile([0.0, 0.0, 100.0], (4, 1)),
          "right": np.tile([0.0, 0.0, 300.0], (4, 1))}


def test_rmse_and_curve_helpers():
    o = _outs([True, False, False, True], shift=0.3)
    rmse, n = cs.rmse_px_max(o.valid, o.left_coeffs, o.right_coeffs,
                             ORACLE, 50)
    assert rmse == pytest.approx(0.3) and n == 4  # 2 frames x 2 sides
    assert cs.curve_max_diff_px([[1e-3, 0.0, 0.0]], [[0.0, 0.0, 0.0]],
                                11) == pytest.approx(0.1)
    assert cs.trace_mismatches([True, False, False, True], ORACLE) == 1
    with pytest.raises(AssertionError, match="covers 4 of 5"):
        cs.trace_mismatches([True] * 5, ORACLE)


def test_gate_chunk_holds_all_three_gates():
    info = cs.gate_chunk(_outs(ORACLE["valid"], 0.1), ORACLE, 50, True)
    assert info["trace_mismatches"] == 0 and info["corridor_ok_share"] == 1
    with pytest.raises(AssertionError, match="validity trace"):
        cs.gate_chunk(_outs([True] * 4), ORACLE, 50, False)
    with pytest.raises(AssertionError, match="rmse_px_max"):
        cs.gate_chunk(_outs(ORACLE["valid"], 0.5), ORACLE, 50, False)
    with pytest.raises(AssertionError, match="corridor certificate"):
        cs.gate_chunk(_outs(ORACLE["valid"], ok=False), ORACLE, 50, True)
    cs.gate_chunk(_outs(ORACLE["valid"], ok=False), ORACLE, 50, False)


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_refused(res):
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_script_fails_without_gpu():
    _assert_refused(_run_script(REPO))


def test_script_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run_script(tmp_path))


def test_main_refuses_a_cpu_backend(monkeypatch, capsys):
    """Past the card query and the card tests, a JAX without a GPU must
    stop the run before any phase and print no result."""
    import lane_tracker_tpu.utils.card as card

    monkeypatch.setattr(card, "card_name_and_power_limit",
                        lambda: "Fake Card, 1.00 W")
    monkeypatch.setattr(cs, "phase_card_tests",
                        lambda: {"compile_s": None, "run_s": 0.0,
                                 "peak_bytes_in_use": "n/a"})
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.main([])
    out = capsys.readouterr().out
    assert "Fake Card, 1.00 W" in out and '"ok"' not in out


def test_compile_cache_yields_to_environment(monkeypatch):
    from lane_tracker_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.compile_cache_dir() is None


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from lane_tracker_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "/.jax_cache/" in ignored


@pytest.fixture(scope="module")
def stills_npz():
    return np.load(REPO / "assets" / "stills.npz")


@pytest.mark.parametrize("i", range(4))
def test_stills_asset_equals_pil_decode(stills_npz, i):
    Image = pytest.importorskip("PIL.Image")
    name = str(stills_npz["names"][i])
    want = np.asarray(Image.open(REPO / "assets" / name).convert("RGB"))
    got = stills_npz["frames"][i]
    assert got.dtype == np.uint8 and got.shape == (720, 1280, 3)
    np.testing.assert_array_equal(got, want)


def test_device_summary_keys():
    from lane_tracker_tpu.utils.card import device_summary

    s = device_summary()
    assert set(s) == {"platform", "kind", "count"}
    assert json.loads(json.dumps(s)) == s
