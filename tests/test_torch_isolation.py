"""The PyTorch port stands alone: importing every module of ``repro_torch``
pulls in neither JAX nor the JAX package, and its entry points refuse to
run on the CPU unless asked."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

SRC = Path(repro_torch.__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("serve.engine", "kernels.flash_attention.kernel",
              "kernels.gossip_mix.kernel", "kernels.gossip_mix.ops",
              "core.topology", "core.spectral", "core.schedule",
              "core.flatbuf", "core.gossip", "core.transforms", "core.optim",
              "core.plan", "data.pipeline", "launch.steps", "launch.train",
              "launch.quickstart", "convert", "models.mamba2",
              "kernels.ssd_scan.kernel", "kernels.ssd_scan.ops",
              "benchmarks.run", "benchmarks.bench_hetero",
              "launch.topology_compare"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine, init_page_pool
    cfg = configs.reduced_config(configs.get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init(cfg, 0)
    params = M.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, n_pages=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_page_pool(cfg, n_pages=4, page_size=4)
    assert ServeEngine(cfg, params, n_pages=8, device="cpu").device.type \
        == "cpu"


def test_train_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import quickstart, train
    argv = ["--nodes", "2", "--steps", "1", "--batch", "1", "--seq", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(steps=1)
    train.main(argv + ["--device", "cpu"])


def test_ssm_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = configs.reduced_config(configs.get_config("mamba2-1.3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, batch=1, cache_len=8)
    params = M.init(cfg, 0, device="cpu")
    prompts = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cfg, params, prompts, max_new=1)
    assert generate(cfg, params, prompts, max_new=2, temperature=0.0,
                    device="cpu").shape == (1, 5)


def test_figure_entry_points_raise_without_a_card_unless_cpu_is_asked():
    """The figure harness, the straggler bench and topology_compare run on
    the card by default, as every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.benchmarks import bench_hetero, run
    from repro_torch.launch import topology_compare
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--only", "transient"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_hetero.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topology_compare.main(["--nodes", "4", "--steps", "2"])
    run.main(["--only", "consensus", "--device", "cpu"])
