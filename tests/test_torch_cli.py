"""tpuimg_torch's CLI on the CPU (``--platform cpu``, tiny shapes): every
case of tests/test_cli.py with the port's rung names (``torch`` for tpuimg's
``xla``, ``cuda`` for its ``pallas``), the stream command, the colour
demos, same-seed autotest logs against tpuimg's CLI line for line, and the
refusal to run without a card unless asked for the CPU."""

import glob
import os
import re

import numpy as np
import pytest
import torch

from tpuimg.cli import main as jax_main
from tpuimg_torch.cli import _parser, main
from tpuimg_torch.ops.color import lab_to_rgb, rgb_to_lab
from tpuimg_torch.utils import imread_gray, imread_rgb, imwrite

CPU = ["--platform", "cpu"]


def run(*argv):
    return main(CPU + list(argv))


@pytest.fixture
def gray_png(tmp_path, rng):
    p = str(tmp_path / "g.png")
    imwrite(p, rng.integers(0, 256, (40, 56), dtype=np.uint8))
    return p


@pytest.fixture
def color_png(tmp_path, rng):
    p = str(tmp_path / "c.png")
    imwrite(p, rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    return p


def test_cli_integral(capsys):
    assert run("integral", "--width", "128", "--height", "64",
               "--nreps", "2") == 0
    out = capsys.readouterr().out
    assert "integral[torch]" in out and "integral[cuda]" in out
    assert out.count("maxdiff=0 [OK]") == 2


def test_cli_autotest(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run("integral-autotest", "--runs", "2", "--max-size", "200",
               "--impl", "torch") == 0
    assert os.path.exists(tmp_path / "res.log")
    assert run("integral-autotest", "--runs", "2", "--max-size", "200") == 0
    lines = (tmp_path / "res.log").read_text().strip().splitlines()
    assert len(lines) == 4 and all(l.endswith(": 0") for l in lines)


def test_cli_autotest_bucketed(tmp_path, monkeypatch, capsys):
    """--bucket pads the drawn frame to multiples of N with zeros; the run
    must stay exact (integral is invariant in the top-left region and the
    full padded frame is verified against the padded oracle)."""
    monkeypatch.chdir(tmp_path)
    assert run("integral-autotest", "--runs", "3", "--max-size", "200",
               "--impl", "torch", "--bucket", "128") == 0
    lines = (tmp_path / "res.log").read_text().strip().splitlines()
    assert len(lines) == 3
    assert all("(bucket" in l and l.endswith(": 0") for l in lines)
    for l in lines:
        wp, hp = l.split("(bucket ")[1].split(")")[0].split(" x ")
        assert int(wp) % 128 == 0 and int(hp) % 128 == 0


def test_cli_he_autotest(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run("he-autotest", "--runs", "2", "--max-size", "200") == 0
    log = (tmp_path / "res.log").read_text()
    assert log.count("tpuimg_torch-he") == 2 and "oracle: 0" in log


def test_cli_morph_autotest(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run("morph-autotest", "--runs", "3", "--max-size", "200",
               "--max-radius", "9") == 0
    lines = (tmp_path / "res.log").read_text().strip().splitlines()
    assert len(lines) == 3
    assert all("erode r" in l or "dilate r" in l for l in lines)
    assert all(l.endswith(": 0") for l in lines)


def test_cli_bucketed_autotests_generic(tmp_path, monkeypatch, capsys):
    """Generic --bucket mode: the frame is drawn at the lattice shape with
    fully random content; float params (sigma, clip) are laddered as in
    tpuimg. The log line records the bucketed shape and the laddered
    param."""
    monkeypatch.chdir(tmp_path)
    assert run("he-autotest", "--runs", "2", "--max-size", "200",
               "--bucket", "128") == 0
    assert run("morph-autotest", "--runs", "2", "--max-size", "200",
               "--max-radius", "5", "--bucket", "128") == 0
    assert run("gaussian-autotest", "--runs", "2", "--max-size", "200",
               "--bucket", "128") == 0
    lines = (tmp_path / "res.log").read_text().strip().splitlines()
    assert len(lines) == 6 and all("(bucket " in l for l in lines)
    for l in lines:
        wp, hp = l.split("(bucket ")[1].split(")")[0].split(" x ")
        assert int(wp) % 128 == 0 and int(hp) % 128 == 0
    # integer ops exact; gaussian rows carry the laddered sigma
    assert all(l.endswith(": 0") for l in lines[:4])
    gauss = [l for l in lines if "-gauss " in l]
    assert len(gauss) == 2
    assert all(" s" in l.split("-gauss ")[1] for l in gauss)


def test_cli_tolerance_autotests(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run("clahe-autotest", "--runs", "2", "--max-size", "200") == 0
    assert run("gaussian-autotest", "--runs", "2", "--max-size", "200") == 0
    assert run("guided-autotest", "--runs", "2", "--max-size", "200") == 0
    log = (tmp_path / "res.log").read_text()
    assert log.count("tpuimg_torch-clahe") == 2
    assert log.count("tpuimg_torch-gauss") == 2
    assert log.count("tpuimg_torch-guided") == 2


def test_cli_guided_autotest_modes(tmp_path, monkeypatch, capsys):
    """Eight runs of seed 0 reach the reflect, shrink and CN1 forms."""
    monkeypatch.chdir(tmp_path)
    assert run("guided-autotest", "--runs", "8", "--max-size", "120") == 0
    log = (tmp_path / "res.log").read_text()
    assert "-guided-cn1 r" in log and " shrink" in log
    assert "8/8 within 0.0001" in capsys.readouterr().out


def test_cli_he(gray_png, capsys):
    assert run("he", gray_png, "--nreps", "2") == 0
    assert os.path.exists(gray_png.replace(".png", "_tpuhe.png"))
    assert "hist_equalize" in capsys.readouterr().out


def test_cli_gaussian(capsys):
    assert run("gaussian", "96", "64", "2", "1.5", "2") == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == 3
    for rung in ("naive2d", "torch", "cuda"):
        assert f"gaussian[{rung}] r=2" in out


def test_cli_gaussian_writes_each_rung(gray_png, capsys):
    assert run("gaussian", "56", "40", "1", "1.0", "2", gray_png) == 0
    for rung in ("naive2d", "torch", "cuda"):
        assert os.path.exists(gray_png.replace(".png", f"_gauss_{rung}.png"))


def test_cli_morphology_open(capsys):
    assert run("morphology", "--op", "open", "--radius", "2",
               "--width", "96", "--height", "64", "--nreps", "2") == 0
    out = capsys.readouterr().out
    assert "morph[torch] open r=2" in out and "morph[cuda] open r=2" in out
    assert out.count("maxdiff=0 [OK]") == 2


def test_cli_guided_rungs(capsys):
    assert run("guided", "--width", "96", "--height", "64",
               "--nreps", "2") == 0
    out = capsys.readouterr().out
    for rung in ("torch", "cuda-twopass", "cuda-onepass"):
        assert f"guided[{rung}] r=4" in out
    assert out.count("[OK]") == 3


def test_cli_sweep(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run("sweep", "morphology", "--radii", "1-2", "--nreps", "2",
               "--width", "96", "--height", "64") == 0
    assert os.path.exists(tmp_path / "sweep_morphology.json")


def test_cli_enhance_demo(gray_png, capsys):
    """The flagship demo runs the 3-rung impl ladder (fused / fused1 /
    staged), verifies each vs the composed oracle, and writes the PNGs."""
    assert run("enhance", gray_png, "--tiles", "4", "--gf-radius", "4",
               "--nreps", "2") == 0
    out = capsys.readouterr().out
    assert ("enhance[fused]" in out and "enhance[fused1]" in out
            and "enhance[staged]" in out)
    assert out.count("[OK]") == 3
    for impl in ("fused", "fused1", "staged"):
        assert os.path.exists(gray_png.replace(".png", f"_enhance_{impl}.png"))


def test_cli_enhance_autotest(tmp_path, monkeypatch, capsys):
    """Flagship-pipeline randomized parity (fused enhance vs composed NumPy
    oracles, <=2 gray steps end to end)."""
    monkeypatch.chdir(tmp_path)
    assert run("enhance-autotest", "--runs", "2", "--max-size", "180") == 0
    log = (tmp_path / "res.log").read_text()
    assert log.count("tpuimg_torch-enhance") == 2
    assert "2/2 within 2" in capsys.readouterr().out


def test_cli_clahe_gray_and_color(gray_png, color_png, capsys):
    assert run("clahe", gray_png, "--nreps", "2") == 0
    assert run("clahe", color_png, "--nreps", "2") == 0
    assert capsys.readouterr().out.count("[OK]") == 2
    # the colour branch: CLAHE on L of the Lab frame, merged back
    from tpuimg_torch import clahe

    rgb = torch.from_numpy(imread_rgb(color_png))
    lab = rgb_to_lab(rgb)
    L = clahe(lab[..., 0], 1.0, 8, 8)
    want = lab_to_rgb(torch.stack([L, lab[..., 1], lab[..., 2]], dim=-1))
    got = imread_rgb(color_png.replace(".png", "_tpuclahe.png"))
    np.testing.assert_array_equal(got, want.numpy())


def test_cli_morphology_color_matches_tpuimg(color_png, tmp_path, capsys):
    jax_png = str(tmp_path / "j.png")
    imwrite(jax_png, imread_rgb(color_png))
    for form in ("rgb", "lab"):
        assert run("morphology", "--color", form, "--radius", "2",
                   "--src", color_png) == 0
        assert jax_main(["--platform", "cpu", "morphology", "--color", form,
                         "--radius", "2", "--src", jax_png]) == 0
    ours = imread_rgb(color_png.replace(".png", "_morph_erode_rgb.png"))
    theirs = imread_rgb(jax_png.replace(".png", "_morph_erode_rgb.png"))
    np.testing.assert_array_equal(ours, theirs)  # per-channel erode: exact
    # lab: the port's own composition exactly (tpuimg's Lab is 1 step away)
    from tpuimg_torch import erode

    lab = rgb_to_lab(torch.from_numpy(imread_rgb(color_png)))
    want = lab_to_rgb(torch.stack([erode(lab[..., 0], 2), lab[..., 1],
                                   lab[..., 2]], dim=-1))
    got = imread_rgb(color_png.replace(".png", "_morph_erode_lab.png"))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.fixture
def frame_dir(tmp_path, rng):
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        imwrite(str(d / f"f{i}.png"),
                rng.integers(0, 256, (48, 64), dtype=np.uint8))
    return d


@pytest.fixture
def loader():
    from tpuimg_torch import native

    if not native.available():
        pytest.skip("native loader does not build here")


def test_cli_stream_enhance(loader, frame_dir, tmp_path, capsys):
    from tpuimg_torch.pipeline import enhance

    out_dir = str(tmp_path / "out")
    assert run("stream", str(frame_dir / "*.png"), "--op", "enhance",
               "--out", out_dir, "--width", "64", "--height", "48") == 0
    written = sorted(glob.glob(os.path.join(out_dir, "*.png")))
    assert len(written) == 3
    out = capsys.readouterr().out
    assert "3 frames" in out
    # through enhance_host: three 48x64 frames up and back, none staged on
    # the CPU
    assert ("moved 9216 B to the device and 9216 B back; 0 B staged"
            in out)
    for path in written:
        src = imread_gray(str(frame_dir / os.path.basename(path)))
        np.testing.assert_array_equal(
            imread_gray(path), enhance(torch.from_numpy(src)).numpy())


@pytest.mark.parametrize("op", ["gaussian", "he", "erode", "clahe"])
def test_cli_stream_ops_match_tpuimg(loader, frame_dir, tmp_path, op):
    """The stream gaussian op uses the library's rint+clip convention, not
    truncation; every op's frames equal tpuimg's stream output, CLAHE's
    within its contract of 1 gray step."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    common = ["stream", str(frame_dir / "f0.png"), "--op", op, "--radius",
              "2", "--width", "64", "--height", "48"]
    assert run(*common, "--out", ours) == 0
    assert jax_main(["--platform", "cpu", *common, "--out", theirs]) == 0
    got = imread_gray(os.path.join(ours, "f0.png"))
    want = imread_gray(os.path.join(theirs, "f0.png"))
    steps = np.abs(got.astype(int) - want.astype(int)).max()
    assert steps <= (1 if op == "clahe" else 0)


def test_cli_stream_no_match(tmp_path, capsys):
    assert run("stream", str(tmp_path / "none*.png")) == 1
    assert "no files match" in capsys.readouterr().out


def test_cli_invalid_parameters_return_2(capsys):
    assert run("gaussian", "96", "64", "0") == 2
    assert "invalid parameters" in capsys.readouterr().err


def _subcommands(parser):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return sorted(sub.choices)


def test_help_lists_tpuimg_subcommands(capsys):
    with pytest.raises(SystemExit):
        jax_main(["--help"])
    jax_help = capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--help"])
    ours = capsys.readouterr().out
    names = _subcommands(_parser())
    assert len(names) == 16
    listed = re.compile(r"\{([a-z0-9,-]+)\}")
    assert sorted(listed.findall(ours)[1].split(",")) == names
    assert sorted(listed.findall(jax_help)[1].split(",")) == names


def test_default_platform_without_a_card_returns_2(tmp_path, monkeypatch,
                                                    capsys):
    """No card and no --platform cpu: exit code 2 with the DeviceError
    text, and the command never runs (nothing computed, no res.log)."""
    import tpuimg_torch.cli as cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(cli, "cmd_integral_autotest",
                        lambda args: ran.append(args) or True)
    assert main(["integral-autotest", "--runs", "1",
                 "--max-size", "100"]) == 2
    assert main(["integral", "--width", "64", "--height", "32"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and not ran
    assert not os.path.exists(tmp_path / "res.log")
    assert err.count("tpuimg_torch: no device:") == 2
    assert "runs on a CUDA card and there is none" in err


def _normalized_log(path):
    text = open(path).read().replace("tpuimg_torch", "tpuimg")
    return text.strip().splitlines()


def _parse(line):
    m = re.fullmatch(r"Size: (\d+) x (\d+), Max difference of (.*) and "
                     r"oracle: (\S+)", line)
    assert m, line
    return (int(m[1]), int(m[2]), m[3]), float(m[4])


@pytest.mark.parametrize("family,extra", [
    ("he-autotest", []),
    ("morph-autotest", ["--max-radius", "9"]),
    ("clahe-autotest", []),
    ("he-autotest", ["--bucket", "64"]),
    ("morph-autotest", ["--bucket", "64"]),
    ("clahe-autotest", ["--bucket", "64"]),
])
def test_autotest_logs_match_tpuimg_for_one_seed(tmp_path, monkeypatch,
                                                  capsys, family, extra):
    """One seed through both CLIs: the same sizes and descriptors (radii,
    tile grids, clip limits, skipped grids), line for line, and the same
    diffs for the exact families. A CLAHE diff is 0 or 1 against the
    oracle in each package (its 1-step contract; tpuimg's rounding on the
    CPU differs from the port's), so there each is held to that."""
    argv = [family, "--runs", "4", "--max-size", "160", "--seed", "11",
            *extra]
    for name, fn in (("ours", main), ("theirs", jax_main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert fn(["--platform", "cpu", *argv]) == 0
    ours = [_parse(l) for l in _normalized_log(tmp_path / "ours/res.log")]
    theirs = [_parse(l) for l in _normalized_log(tmp_path / "theirs/res.log")]
    assert len(ours) == len(theirs) == 4
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    if family == "clahe-autotest":
        assert all(d <= 1 for _, d in ours + theirs)
    else:
        assert [d for _, d in ours] == [d for _, d in theirs] == [0] * 4


def _python(*args, code=None):
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    argv = [sys.executable, "-c", code] if code else [sys.executable, *args]
    return subprocess.run(argv, cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)


def test_new_modules_import_no_jax_tpuimg_or_triton():
    code = ("import sys, tpuimg_torch.cli, tpuimg_torch.native, "
            "tpuimg_torch.profiling, tpuimg_torch.oracle, "
            "tpuimg_torch.ops.color, tpuimg_torch.ops.metrics, "
            "tpuimg_torch.utils, tpuimg_torch.core.timing; "
            "bad = [m for m in ('jax', 'tpuimg', 'triton') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = _python(code=code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_module_entry_point_runs_on_the_cpu_when_asked():
    proc = _python("-m", "tpuimg_torch", "--platform", "cpu", "integral",
                   "--width", "128", "--height", "64", "--nreps", "2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("maxdiff=0 [OK]") == 2
    assert "device=cpu" in proc.stderr and "host clock" in proc.stderr
