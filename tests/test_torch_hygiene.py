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
            "repro_torch.federated.server, repro_torch.models.ssm, "
            "repro_torch.kernels.ssd_scan.ops, repro_torch.models.quant, "
            "repro_torch.core.clustering, repro_torch.core.proxy, "
            "repro_torch.core.vaa, repro_torch.core.distill, "
            "repro_torch.federated.simulation, repro_torch.checkpoint, "
            "repro_torch.core.baselines, repro_torch.launch.distill_run, "
            "repro_torch.configs.device_models, repro_torch.federated, "
            "repro_torch.federated.async_fleet, repro_torch.optim.adamw; "
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


# bucketed admission, speculative decode and sharded serving are ported:
# their cases hold the engine's validation (a chunk length under 1, a
# ladder without a chunk length, speculation on a model without an MTP
# head, a mesh that is no DeviceMesh of dims ("data", "model")) instead
@pytest.mark.parametrize("kw,err,match", [
    ({"chunk_len": 0}, ValueError, "chunk_len must be >= 1"),
    ({"buckets": [8, 16]}, ValueError, "buckets requires chunk_len"),
    ({"speculate": 2}, ValueError, "requires an MTP head"),
    ({"mesh": object()}, TypeError, "DeviceMesh of dims")],
    ids=["chunk_len", "buckets", "speculate", "mesh"])
@pytest.mark.parametrize("cls", [ServeEngine, PagedServeEngine])
def test_unported_engine_options_raise(small, cls, kw, err, match):
    cfg, params = small
    with pytest.raises(err, match=match):
        cls(params, cfg, device="cpu", **kw)


# sharded serving's flags are ported (tests/test_torch_serve_sharded.py):
# --check-unsharded without --sharded is the reference's usage error;
# multi-host fleets are ported (tests/test_torch_fleet_hosts.py): a single
# model ignores --n-hosts, as the reference does, and a fleet of more hosts
# than ranks is the reference's oversubscription error; what stays refused
# is the training launcher's production mesh
@pytest.mark.parametrize("launcher,flag,err", [
    ("serve", ["--check-unsharded"], SystemExit),
    ("train", ["--production-mesh"], NotImplementedError),
    ("train", ["--n-hosts", "2", "--steps", "1", "--batch", "1", "--seq",
               "8"], None),
    ("train", ["--fleet", "4", "--n-hosts", "2"], ValueError)],
    ids=["check-unsharded", "production-mesh", "n-hosts",
         "fleet-n-hosts"])
def test_unported_launcher_flags_raise(launcher, flag, err, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    argv = ["--arch", "tinyllama-1.1b", "--device", "cpu", *flag]
    if err is None:
        losses = mod.main(argv)
        assert len(losses) == 1 and np.isfinite(losses).all()
        return
    with pytest.raises(err) as exc:
        mod.main(argv)
    if err is SystemExit:
        assert exc.value.code == 2
        assert "requires --sharded" in capsys.readouterr().err
    elif err is ValueError:
        assert "fleet mesh wants 2 hosts" in str(exc.value)
    else:
        assert "not ported yet" in str(exc.value)


@pytest.mark.parametrize("flag", [["--buckets", "8,16"],
                                  ["--check-unbucketed"]])
def test_bucket_flags_need_bucket(flag, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.parse_args(["--arch", "tinyllama-1.1b", "--device", "cpu",
                          *flag])
    assert exc.value.code == 2
    assert "requires --bucket" in capsys.readouterr().err


# every family is ported: the gemma family's and the VLM's cases turned
# positive (test_gemma_and_vlm_archs_resolve), enc-dec's too
# (test_every_reference_arch_is_ported); an unknown name is still refused
@pytest.mark.parametrize("arch", ["nope"])
def test_unported_arch_raises(arch):
    with pytest.raises(KeyError, match="not ported yet"):
        get_config(arch)


def test_every_reference_arch_is_ported():
    """No architecture of the reference registry is missing from the
    port's, whisper-small (the encoder-decoder family) the last."""
    from repro.configs.registry import ALL
    from repro_torch.configs.registry import PORTED
    assert set(ALL) <= set(PORTED)
    assert get_config("whisper-small").arch_type == "encdec"


@pytest.mark.parametrize("variant", ["full", "reduced"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma2-27b",
                                  "paligemma-3b"])
def test_gemma_and_vlm_archs_resolve(arch, variant):
    """Every field equal to the reference's config (``use_pallas`` is
    ``use_kernels`` in the port, True by default)."""
    import dataclasses

    from repro.configs import get_config as reference_config
    want = dataclasses.asdict(reference_config(arch, variant=variant))
    want.pop("use_pallas")
    got = dataclasses.asdict(get_config(arch, variant=variant))
    assert got.pop("use_kernels") is True
    assert got == want


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
