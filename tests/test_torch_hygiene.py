"""Boundaries of the PyTorch port: no JAX, explicit devices, refusals.

The port (``src/repro_torch``) and ``chip_smoke.py`` import neither
``jax`` nor the reference package ``repro``; entry points default to
the card and refuse to fall back to the CPU; features that are not
ported yet raise ``NotImplementedError``.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.paged_attn.ops, "
            "repro_torch.kernels.kd_loss.ops, repro_torch.launch.train, "
            "repro_torch.federated.device, repro_torch.data.federated, "
            "repro_torch.optim, repro_torch.utils.pytree, "
            "repro_torch.kernels.moe_gemm.ops, "
            "repro_torch.kernels.moe_dispatch.ops, repro_torch.models.moe, "
            "repro_torch.core.merge, repro_torch.core.tuning, "
            "repro_torch.federated.server; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def small():
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    return cfg, M.init_params(cfg, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("cls", [ServeEngine, PagedServeEngine])
def test_default_device_needs_cuda(small, cls, monkeypatch):
    cfg, params = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(params, cfg)
    cls(params, cfg, device="cpu")  # the CPU only when asked for


def test_launcher_default_device_needs_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "tinyllama-1.1b"])


def test_launcher_serves_on_the_cpu_when_asked():
    from repro_torch.launch import serve
    comps = serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                        "--paged", "--mixed", "--requests", "3",
                        "--prompt-len", "12", "--gen", "6"])
    assert [len(c.tokens) for _, c in sorted(comps.items())] == [6, 3, 2]


@pytest.mark.parametrize("kw", [{"chunk_len": 4}, {"buckets": [8, 16]},
                                {"speculate": 2}, {"kv_dtype": "int8"},
                                {"mesh": object()}],
                         ids=lambda kw: next(iter(kw)))
@pytest.mark.parametrize("cls", [ServeEngine, PagedServeEngine])
def test_unported_engine_options_raise(small, cls, kw):
    cfg, params = small
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cls(params, cfg, device="cpu", **kw)


@pytest.mark.parametrize("flag", [["--bucket"], ["--speculate"],
                                  ["--kv-dtype", "int8"], ["--sharded"],
                                  ["--temperature", "0.7"]])
def test_unported_launcher_flags_raise(flag):
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="not ported yet"):
        serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu", *flag])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b", "nope"])
def test_unported_arch_raises(arch):
    with pytest.raises(KeyError, match="not ported yet"):
        get_config(arch)


def test_engine_refuses_params_on_another_device(small):
    cfg, params = small
    meta = M.init_params(cfg, generator="meta")
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine(meta, cfg, device="cpu")
    with pytest.raises(ValueError, match="tokens"):
        ServeEngine(params, cfg, device="cpu").submit(
            {"tokens": np.zeros((2, 4), np.int32)}, max_new=2)


def test_chip_smoke_without_a_card_prints_no_result(tmp_path):
    """Without CUDA, and alone in a directory without the port, the smoke
    script exits non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
