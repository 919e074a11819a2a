"""The port's CLI (adcensus_torch/cli.py) and stage timing
(adcensus_torch/utils/profiling.py) on the CPU, following
tests/test_cli.py: argparse paths, an end-to-end run on tiny synthetic
PNGs, every tunable flag, the parity mode against ``match(...,
gray_mode="host64")`` with the in-place median, ``--timing`` and
``--dump-stages`` against the JAX package's stage names and keys."""
import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch import cli
from adcensus_torch.config import ADCensusOptions
from adcensus_torch.io.image import load_image_rgb, save_png
from adcensus_torch.stages import pipeline
from adcensus_torch.synthetic import two_layer_pair
from adcensus_torch.utils import profiling
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import cost as jax_cost
from adcensus_tpu.stages import pipeline as jax_pipeline
from adcensus_tpu.utils import profiling as jax_profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, MAX_D = 32, 48, 8
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine",
          "total")


def _run_cli(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "adcensus_torch.cli", "--device", "cpu",
         *args],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
    )


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """A seeded 32x48 synthetic pair written as PNGs: (left path, right
    path, left, right)."""
    left, right, _ = two_layer_pair(H, W, 2, 5, seed=1)
    d = tmp_path_factory.mktemp("pair")
    lp, rp = str(d / "l.png"), str(d / "r.png")
    save_png(left, lp)
    save_png(right, rp)
    return lp, rp, left, right


def test_cli_rejects_unknown_pair():
    r = _run_cli(["--pair", "Bogus"])
    assert r.returncode != 0
    assert "unknown pair" in r.stderr
    assert "Cone" in r.stderr  # lists the valid names


def test_cli_requires_inputs():
    r = _run_cli([])
    assert r.returncode != 0
    assert "provide LEFT RIGHT paths or --pair NAME" in r.stderr


def test_cli_end_to_end_tiny(pngs, tmp_path):
    """Metrics JSON, the two saved PNGs and the point cloud."""
    lp, rp, _, _ = pngs
    prefix = str(tmp_path / "out" / "pair")
    cloud = str(tmp_path / "cloud.txt")
    r = _run_cli([lp, rp, "0", str(MAX_D), "--out", prefix, "--cloud",
                  cloud])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "density_pct" in r.stdout
    for suffix in ("-d.png", "-c.png"):
        img = load_image_rgb(prefix + suffix)
        assert img.shape == (H, W, 3)
    lines = open(cloud).read().strip().splitlines()
    assert lines and all(len(line.split()) == 6 for line in lines)


def test_cli_tunable_flags(pngs):
    """Every tunable runs through the real CLI; an unknown flag is
    rejected."""
    lp, rp, _, _ = pngs
    r = _run_cli([
        lp, rp, "0", str(MAX_D), "--no-save",
        "--lambda-ad", "12", "--lambda-census", "25",
        "--cross-l1", "8", "--cross-l2", "4", "--cross-t1", "18",
        "--cross-t2", "5", "--so-p1", "0.5", "--so-p2", "2.0",
        "--so-tso", "12", "--irv-ts", "10", "--irv-th", "0.5",
        "--lrcheck-thres", "1.5", "--no-do-lr-check", "--no-do-filling",
        "--do-discontinuity-adjustment", "--exact-median",
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "density_pct" in r.stdout
    r = _run_cli([lp, rp, "0", str(MAX_D), "--no-save", "--bogus-flag", "1"])
    assert r.returncode != 0


class _Spy:
    """Stands in for cli.run_pair: records its arguments and runs the
    real one."""

    def __init__(self):
        self.calls = []

    def __call__(self, left, right, opts, *args, **kwargs):
        out = _REAL_RUN_PAIR(left, right, opts, *args, **kwargs)
        self.calls.append((opts, kwargs, out[0]))
        return out


_REAL_RUN_PAIR = cli.run_pair


def _spy_main(monkeypatch, argv):
    spy = _Spy()
    monkeypatch.setattr(cli, "run_pair", spy)
    cli.main(argv)
    (call,) = spy.calls
    return call


def test_cli_sets_every_tunable(pngs, monkeypatch):
    """The CLI's flags are the JAX CLI's tunables (every options field
    but the disparity range), and each one reaches the options."""
    lp, rp, _, _ = pngs
    values = {"lambda_ad": 12, "lambda_census": 25, "cross_L1": 8,
              "cross_L2": 4, "cross_t1": 18, "cross_t2": 5, "so_p1": 0.5,
              "so_p2": 2.0, "so_tso": 12, "irv_ts": 10, "irv_th": 0.5,
              "lrcheck_thres": 1.5, "do_lr_check": False,
              "do_filling": False, "do_discontinuity_adjustment": True,
              "exact_median": True}
    names = {f.name for f in dataclasses.fields(ADCensusOptions)}
    assert set(values) == names - {"min_disparity", "max_disparity"}
    argv = [lp, rp, "0", str(MAX_D), "--no-save", "--device", "cpu"]
    for name, v in values.items():
        flag = "--" + name.replace("_", "-").lower()
        if isinstance(v, bool):
            argv.append(flag if v else "--no-" + flag[2:])
        else:
            argv += [flag, str(v)]
    opts, kwargs, _ = _spy_main(monkeypatch, argv)
    assert opts == ADCensusOptions(max_disparity=MAX_D, **values)
    assert kwargs["gray_mode"] == "device"
    assert {f.name for f in dataclasses.fields(JaxOptions)} == names


def test_cli_parity_equals_host64_match(pngs, monkeypatch):
    """--parity runs match(..., gray_mode="host64") on the roll backend
    with the in-place median, bit for bit; --no-exact-median takes the
    median out again."""
    lp, rp, left, right = pngs
    opts, kwargs, disp = _spy_main(
        monkeypatch, [lp, rp, "0", str(MAX_D), "--no-save", "--device",
                      "cpu", "--parity"])
    assert opts.exact_median and kwargs["gray_mode"] == "host64"
    assert kwargs["cross_backend"] == "roll"
    want = pipeline.match(left, right,
                          ADCensusOptions(max_disparity=MAX_D,
                                          exact_median=True),
                          gray_mode="host64", device="cpu")["disparity"]
    np.testing.assert_array_equal(disp.view(np.uint32),
                                  want.view(np.uint32))
    default = pipeline.match(left, right, ADCensusOptions(
        max_disparity=MAX_D), device="cpu")["disparity"]
    assert not np.array_equal(disp, default)
    opts, _, _ = _spy_main(
        monkeypatch, [lp, rp, "0", str(MAX_D), "--no-save", "--device",
                      "cpu", "--parity", "--no-exact-median"])
    assert not opts.exact_median


@pytest.mark.parametrize("backend,cross_backend",
                         [("pallas", "roll"), ("jnp", "roll"),
                          ("matmul", "matmul"), (None, "roll")])
def test_cli_backend_names(pngs, monkeypatch, backend, cross_backend):
    lp, rp, _, _ = pngs
    argv = [lp, rp, "0", str(MAX_D), "--no-save", "--device", "cpu"]
    if backend:
        argv += ["--backend", backend]
    _, kwargs, _ = _spy_main(monkeypatch, argv)
    assert kwargs["cross_backend"] == cross_backend


def test_cli_needs_cuda_by_default(pngs, monkeypatch, capsys):
    """Without a card the default device stops the CLI before any work;
    it does not run on the CPU."""
    lp, rp, _, _ = pngs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spy = _Spy()
    monkeypatch.setattr(cli, "run_pair", spy)
    with pytest.raises(SystemExit) as err:
        cli.main([lp, rp, "0", str(MAX_D), "--no-save"])
    assert err.value.code != 0 and not spy.calls
    assert "CUDA" in capsys.readouterr().err


def _jax_dump_keys():
    """The keys of JAX's match_staged dump, read from its source (its
    np.savez_compressed call): running it eagerly takes too long here."""
    tree = ast.parse(open(jax_profiling.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "savez_compressed"):
            return [kw.arg for kw in node.keywords]
    raise AssertionError("no savez_compressed call in JAX's profiling")


def test_cli_timing_and_dump_stages(pngs, tmp_path):
    """--timing prints the six stages and a total; --dump-stages writes
    JAX's keys, each of the shape and type JAX's match_core gives it."""
    lp, rp, left, right = pngs
    dump = str(tmp_path / "stages.npz")
    r = _run_cli([lp, rp, "0", str(MAX_D), "--no-save", "--timing",
                  "--dump-stages", dump])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [line.split(":")[0].strip() for line in r.stdout.splitlines()
             if "Mpix*disp/s" in line]
    assert tuple(lines) == STAGES
    assert "density_pct" in r.stdout
    z = np.load(dump)
    assert sorted(z.files) == sorted(_jax_dump_keys())
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    ref = jax_pipeline.match_core(
        jl, jr, jax_cost.compute_gray(jl), jax_cost.compute_gray(jr),
        JaxOptions(max_disparity=MAX_D), return_intermediates=True,
        use_pallas=False,
    )
    for k in z.files:
        assert z[k].shape == ref[k].shape and z[k].dtype == ref[k].dtype, k


def test_match_staged_equals_match():
    """match_staged's stages chain to match_device's disparity (device
    gray), and its timings cover the six stages."""
    left, right, _ = two_layer_pair(H, W, 2, 5, seed=2)
    opts = ADCensusOptions(max_disparity=MAX_D, exact_median=True,
                           do_discontinuity_adjustment=True)
    res = profiling.match_staged(left, right, opts, device="cpu",
                                 warmup=False)
    assert tuple(res["timings"]) == STAGES == tuple(res["throughput"])
    assert all(t > 0 for t in res["timings"].values())
    want = pipeline.match_device(left, right, opts, device="cpu").numpy()
    np.testing.assert_array_equal(res["disparity"].view(np.uint32),
                                  want.view(np.uint32))


def test_jax_cli_stage_names_match():
    """The JAX CLI prints match_staged's timings by key; the port's keys
    are the stage names run() is given in JAX's match_staged."""
    tree = ast.parse(open(jax_profiling.__file__).read())
    names = [node.args[0].value for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", "") == "run"]
    assert tuple(names) + ("total",) == STAGES


def test_trace_writes_a_chrome_trace(tmp_path):
    out, path = profiling.trace(lambda a: a * 2, torch.ones(3),
                                trace_dir=tmp_path)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert path.exists() and path.stat().st_size > 0
