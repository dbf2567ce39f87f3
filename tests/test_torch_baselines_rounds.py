"""The paper's multi-round and centralized baselines in the port
(``core/baselines/{centralized,fedavg,fedjets}.py``) and its on-device
families (``configs/device_models.py``) against the JAX reference, on
the CPU.

Each runs in both packages on the ``benchmarks/common.py`` configs, f32,
N 2 (``test_torch_baselines.run_methods``: the init bridge, which asserts
each draw's seed, and the reference compiled with XLA's optimizations
off): centralized training 3 steps, FedAvg (on ``gpt2-tiny``) and FedJETS
2 rounds of 2 local steps, the MoE dropless.

Limits are ``test_torch_baselines``' (readings on this CPU in brackets):
loss histories 2e-6 relative [8.5e-8], ``log_ppl`` and per-domain log-ppl
1e-6 relative [worst 2.0e-7], accuracies 1e-6 absolute [equal];
``comm_bytes``, ``local_model_bytes`` and FedJETS' expert choices
exactly; FedJETS' slicing and write-back bit for bit against the
reference's (its numpy loop of per-owner sums); each device family's
full config field for field, and its reduced variant's loss and metrics
1e-5 relative on both port paths [7.6e-8].
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import device_models as jdm
from repro.core.baselines import fedjets as jfedjets
from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import reduced as jreduced
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.baselines import fedjets
from repro_torch.models import model as M
from repro_torch.utils.pytree import tree_bytes, tree_paths

from test_torch_baselines import (LOSS_RTOL, N, ROUNDS, _configs_n,
                                  _to_jax, assert_matches_reference,
                                  run_methods)
from test_torch_simulation import fast_reference_compiles, jax_cfg
from test_torch_train import port_cfg  # repo root on sys.path

METHODS = ["centralized", "fedavg", "fedjets"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return run_methods(METHODS, with_fleet=False)


@pytest.mark.parametrize("name", METHODS)
def test_baseline_matches_reference(runs, name):
    assert_matches_reference(runs, name)


def test_comm_bytes_follow_each_baselines_formula(runs):
    sim, scfg, fam = _configs_n(port=True)
    rep = runs["port"]
    assert rep["centralized"]["comm_bytes"] == \
        N * sim.device_steps * sim.device_batch * (sim.seq_len + 1) * 4
    dense = tree_bytes(M.init_params(fam[0], generator="meta"))
    assert rep["fedavg"]["comm_bytes"] == 2 * dense * N * ROUNDS
    local = tree_bytes(M.init_params(scfg.moe_cfg.replace(n_experts=2),
                                     generator="meta"))
    assert rep["fedjets"]["local_model_bytes"] == local
    assert rep["fedjets"]["comm_bytes"] == 2 * local * N * ROUNDS


def test_every_init_draw_crossed_the_bridge(runs):
    """Centralized ``seed + 7``, FedAvg ``+11``, FedJETS ``+13``."""
    assert runs["hits"] == {"centralized": [("params", 7)],
                            "fedavg": [("params", 11)],
                            "fedjets": [("params", 13)]}


def test_fedjets_expert_choices_match_reference(runs):
    """Every device's experts, round by round, as the reference sliced
    them (``np.random.default_rng(seed + 17)``)."""
    rng = np.random.default_rng(0 + 17)
    want = [sorted(rng.choice(4, size=2, replace=False).tolist())
            for _ in range(N * ROUNDS)]
    assert runs["experts"]["port"] == runs["experts"]["ref"] == want


def test_fedjets_slice_and_write_back_bit_for_bit():
    """``_slice_experts`` and ``_write_back`` on random trees (3 of 6
    experts a device, one expert owned by nobody): equal to the
    reference's, bit for bit."""
    cfg_j = JModelConfig(name="m", arch_type="moe", n_layers=2, d_model=16,
                           n_heads=2, n_kv_heads=2, head_dim=8, d_ff=32,
                           n_experts=6, top_k=2, moe_d_ff=24,
                           n_shared_experts=1, vocab_size=40,
                           dtype="float32").validate()
    cfg = port_cfg(cfg_j)
    g = torch.Generator().manual_seed(3)
    glob = M.init_params(cfg, generator=g)
    ids = [[0, 2, 5], [1, 2, 3], [0, 3, 5]]
    local_cfg = cfg.replace(n_experts=3)
    locals_ = [M.init_params(local_cfg, generator=g) for _ in ids]
    for i, lp in enumerate(locals_):
        sl = fedjets._slice_experts(glob, ids[i])
        want = jfedjets._slice_experts(_to_jax(glob, cfg), ids[i])
        for (p, t), w in zip(tree_paths(sl), jax.tree.leaves(want)):
            assert np.array_equal(t.numpy(), np.asarray(w)), p
    got = fedjets._write_back(glob, locals_, ids, 6)
    want = jfedjets._write_back(_to_jax(glob, cfg),
                                [_to_jax(lp, local_cfg) for lp in locals_],
                                ids, 6)
    for (p, t), w in zip(tree_paths(got), jax.tree.leaves(want)):
        assert np.array_equal(t.numpy(), np.asarray(w)), p
    # expert 4 has no owner and keeps the global weights
    assert torch.equal(got["blocks"]["sub0"]["moe"]["wo"][:, 4],
                       glob["blocks"]["sub0"]["moe"]["wo"][:, 4])


@functools.lru_cache(maxsize=None)
def _family_reference(cfg_j):
    """The reference's weights (seed 1), a batch and its loss and metrics
    for one reduced structure (three of the four families reduce to the
    same one; only their names differ)."""
    toks = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
    with fast_reference_compiles():
        pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
        out = jax.jit(JM.loss_fn, static_argnums=1)(
            pj, cfg_j, {"tokens": jnp.asarray(toks[:, :-1]),
                        "labels": jnp.asarray(toks[:, 1:])})
    return jax.tree.map(np.asarray, pj), toks, out


@pytest.mark.parametrize("arch", ["gpt2", "gpt2-medium", "olmo-1.2b",
                                  "bloom-1.1b"])
def test_device_family_forward_and_loss_match_reference(arch):
    """The port's copy of each on-device family: the full config equal to
    the reference's field for field, and the reduced variant's loss and
    metrics on the reference's weights, converted."""
    full = get_config(arch)
    ref_full = {"gpt2": jdm.GPT2, "gpt2-medium": jdm.GPT2_MEDIUM,
                "olmo-1.2b": jdm.OLMO_1_2B, "bloom-1.1b": jdm.BLOOM_1_1B}[arch]
    assert jax_cfg(full.replace(use_kernels=False)) == ref_full
    cfg_j = jreduced(ref_full)
    cfg = get_config(arch, variant="reduced").replace(use_kernels=False)
    assert jax_cfg(cfg) == cfg_j
    pj, toks, (lj, mj) = _family_reference(
        cfg_j.replace(name="", citation=""))
    params = convert.params_from_jax(pj, cfg)
    for use_kernels in (False, True):
        loss, m = M.loss_fn(params, cfg.replace(use_kernels=use_kernels),
                            {"tokens": torch.as_tensor(toks[:, :-1]),
                             "labels": torch.as_tensor(toks[:, 1:])})
        np.testing.assert_allclose(loss.item(), float(lj), rtol=LOSS_RTOL)
        for k in ("nll", "tokens", "accuracy"):
            np.testing.assert_allclose(m[k].item(), float(mj[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert np.isfinite(loss.item())
