"""Import hygiene of the port: reni_tpu_torch (every module, the kernels'
anatomy probes, the config, data and codec modules, the renderer
(render/), the evaluation harness (eval.py, cli/evaluate.py), the export,
baselines, conversion and assets modules, the tensor-parallel decoder
(parallel/tp.py), the chip lock (utils/chiplock.py, the port's own copy)
and the precompiler (train/precompile.py) included), chip_smoke.py,
time_kernels.py and examples/fit_prior_torch.py import neither JAX nor the
JAX package nor its benchmarks, nor at module level OpenCV, PIL or PyYAML
(which the card's machine does not have) or scipy, turn no TF32 on, and the
entry points run on the card unless the CPU is asked for."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ["chip_smoke", "time_kernels", "examples.fit_prior_torch"]
PORT_FILES = sorted((ROOT / "reni_tpu_torch").rglob("*.py")) + [
    ROOT / f"{s.replace('.', '/')}.py" for s in SCRIPTS]
OPTIONAL = ("cv2", "PIL", "yaml", "imageio", "scipy")


def _modules():
    pkg = ROOT / "reni_tpu_torch"
    names = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_the_module_list_covers_this_slice():
    names = set(_modules())
    assert {"reni_tpu_torch.render.mesh", "reni_tpu_torch.render.rasterizer",
            "reni_tpu_torch.render.shading", "reni_tpu_torch.render.inverse",
            "reni_tpu_torch.eval", "reni_tpu_torch.cli.evaluate",
            "reni_tpu_torch.cli.run", "reni_tpu_torch.train.logging_utils",
            "reni_tpu_torch.train.visualize", "reni_tpu_torch.utils.profiling",
            "reni_tpu_torch.cli.export", "reni_tpu_torch.cli.convert",
            "reni_tpu_torch.baselines.spherical_harmonics",
            "reni_tpu_torch.baselines.spherical_gaussians", "reni_tpu_torch.utils.convert",
            "reni_tpu_torch.utils.assets", "reni_tpu_torch.data.piz", "reni_tpu_torch.data.b44",
            "reni_tpu_torch.data.dwa", "reni_tpu_torch.parallel", "reni_tpu_torch.parallel.mesh",
            "reni_tpu_torch.parallel.multihost", "reni_tpu_torch.parallel.tp",
            "reni_tpu_torch.utils.chiplock", "reni_tpu_torch.utils.progress",
            "reni_tpu_torch.train.precompile"} <= names


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules() + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'reni_tpu' or m.startswith(('reni_tpu.', 'benchmarks')))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_importing_the_port_leaves_float32_matmuls_full_precision():
    """No module of the port (nor the two scripts on import) turns TF32 on or
    lowers torch's float32 matmul precision: the shading's specular power
    (render/shading.py) would carry a 10-bit mantissa into every highlight."""
    code = (
        "import importlib, json, torch\n"
        f"for m in {_modules() + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps([torch.backends.cuda.matmul.allow_tf32,\n"
        "                  torch.get_float32_matmul_precision()]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    tf32, precision = json.loads(res.stdout.strip().splitlines()[-1])
    assert tf32 is False and precision == "highest"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_turn_no_tf32_on(path):
    """No source of the port sets a TF32 flag or the float32 matmul
    precision, except chip_smoke.py, which turns TF32 off for its own run,
    and the trainer's ``_apply_precision``, which sets the precision a
    config's TPU.PRECISION asks for: "highest" unless it asks for
    tensorfloat32 (tests/test_torch_cli.py::test_precision_knob)."""
    src = path.read_text()
    sets = re.findall(r"(allow_tf32\s*=\s*\w+|set_float32_matmul_precision\([^)]*\))", src)
    if path == ROOT / "reni_tpu_torch" / "cli" / "run.py":
        assert sets == ['set_float32_matmul_precision("high" if precision == "tensorfloat32" '
                        'else "highest")'], sets
        return
    assert all(s.replace(" ", "").endswith("=False") for s in sets), sets


def test_importing_the_port_loads_no_optional_image_or_yaml_library():
    """Nothing on chip_smoke.py's path (every module of the port, the
    scripts) imports cv2, PIL, yaml or scipy when it is imported: the first
    three are imported inside the functions that read such files (an .hdr
    or a non-PNG LDR image, a YAML config), and the card's machine has none
    of them; the port needs no scipy (the SH basis is its own recurrence)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules() + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in {OPTIONAL!r} if m in sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_optional_library_at_module_level(path):
    """No top-level import of cv2, PIL, yaml, imageio or scipy in a source
    of the port (an indented import inside a function is the way)."""
    bad = re.compile(rf"^(import|from)\s+({'|'.join(OPTIONAL)})(\.|\s|$)", re.M)
    src = path.read_text()
    assert not bad.search(src), bad.search(src).group(0)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    src = path.read_text()
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|reni_tpu|benchmarks)(\.|\s|$)", re.M)
    assert not bad.search(src), bad.search(src).group(0)


def test_entry_points_need_the_card_by_default(monkeypatch, tmp_path):
    """With no device argument and no card, every entry point raises
    instead of running on the CPU."""
    from reni_tpu_torch import params, serve
    from reni_tpu_torch.cli import serve as cli_serve
    from reni_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = str(ROOT / "data" / "Zoo" / "latent_dim_49_net_5_256_vad_cbc_tanh_hdr" / "checkpoint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_decoder(ck)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.make_server(ck, port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(["--decoder", ck, "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params.from_numpy({"w": [1.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.export_from_checkpoint(ck, str(tmp_path / "a.pt2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_exported(str(tmp_path / "a.pt2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(["--artifact", str(tmp_path / "a.pt2"), "--port", "0"])
    from reni_tpu_torch.utils import assets

    with pytest.raises(RuntimeError, match="no CUDA device"):
        assets.select_device()
    from reni_tpu_torch.cli import run as cli_run
    from reni_tpu_torch.utils.config import get_cfg_defaults

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_run.main(get_cfg_defaults(), log_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a card
    (this host has none; on the card it would run the smoke test)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _time_kernels(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(ROOT / "time_kernels.py"), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=240)


def test_time_kernels_refuses_without_a_card():
    """time_kernels.py times nothing on the CPU: it exits non-zero and prints
    no time without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: time_kernels.py would run for real")
    res = _time_kernels()
    assert res.returncode != 0 and " ms" not in res.stdout


def test_time_kernels_anatomy_refuses_without_a_card():
    """The same for its --anatomy mode."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: time_kernels.py would run for real")
    res = _time_kernels("--anatomy")
    assert res.returncode != 0 and " ms" not in res.stdout


def test_every_kernel_source_is_built_by_chip_smoke():
    """chip_smoke.build_all compiles every csrc/*.cu, all at once: the five
    sources and the tiled passes' four (one per conditioning and dtype)."""
    import chip_smoke

    from reni_tpu_torch.kernels import siren_step

    sources = sorted(p.stem for p in (ROOT / "reni_tpu_torch" / "kernels" / "csrc").glob("*.cu"))
    assert sorted(chip_smoke.KERNEL_SOURCES) == sources
    assert len(sources) == 9 and set(siren_step.TILED_SOURCES) < set(sources)
