"""The port's sharding rules and decode-mesh shapes against the JAX
reference's, in process, with no devices.

For every ported architecture, reduced: ``param_specs`` (with and
without ``fsdp`` and ``ep_all``), ``opt_state_specs`` (fp32 and int8
moments), ``batch_spec``, ``cache_specs`` and ``paged_cache_specs``
(every ``kv_dtype``) equal the reference's ``PartitionSpec``s entry for
entry on abstract (16, 16) and (2, 2) meshes; the port's trees are built
on the meta device, the reference's by ``jax.eval_shape``.  Also
``fleet_specs``, ``decode_mesh_shape`` for 1-8 devices and
``rules.block`` on the expert layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.launch import mesh as jmesh
from repro.models import model as JM
from repro.models import quant as jquant
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro.utils.pytree import path_str
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.registry import PORTED
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.models import quant
from repro_torch.optim import adamw
from repro_torch.sharding import rules

ARCHS = sorted(PORTED)
MESHES = {"16x16": (16, 16), "2x2": (2, 2)}
NAMES = ("data", "model")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape):
    return (rules.abstract_mesh(shape, NAMES),
            jrules.abstract_mesh(shape, NAMES))


def _jax_flat(specs):
    """{path: entries} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, P))
    return {path_str(p): tuple(s) for p, s in flat}


def _assert_same(port_specs, jax_specs):
    got = convert.flatten(port_specs)
    want = _jax_flat(jax_specs)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


_TREES = {}


def _params(arch):
    """(port meta params, reference abstract params) of the reduced arch."""
    if arch not in _TREES:
        cfg = get_config(arch, variant="reduced")
        cfg_j = jax_config(arch, variant="reduced")
        _TREES[arch] = (M.init_params(cfg, generator="meta"),
                        jax.eval_shape(lambda: JM.init_params(
                            jax.random.PRNGKey(0), cfg_j)))
    return _TREES[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_reference(arch, mesh):
    pt, pj = _params(arch)
    m, mj = _meshes(MESHES[mesh])
    for fsdp in (True, False):
        for ep_all in (False, True):
            _assert_same(rules.param_specs(pt, m, fsdp=fsdp, ep_all=ep_all),
                         jrules.param_specs(pj, mj, fsdp=fsdp, ep_all=ep_all))
    for policy in ("", "int8"):
        st = adamw.adamw_init(pt, policy=policy)
        sj = jax.eval_shape(lambda: jadamw.adamw_init(pj, policy=policy))
        got = rules.opt_state_specs(pt, m, state=st)
        want = jrules.opt_state_specs(pj, mj, state=sj)
        assert set(got) == set(want)
        for key in want:
            if key == "step":
                assert got[key] == tuple(want[key]) == ()
            else:
                _assert_same(got[key], want[key])


def _caches(arch, kv, *, B, S):
    cfg = get_config(arch, variant="reduced")
    cfg_j = jax_config(arch, variant="reduced")
    pol, pol_j = quant.CachePolicy(kv), jquant.CachePolicy(kv)
    ct = M.init_decode_cache(cfg, B, S, device="meta", policy=pol)
    cj = jax.eval_shape(lambda: JM.init_decode_cache(cfg_j, B, S,
                                                     policy=pol_j))
    pt = M.init_paged_cache(cfg, B, 32, 8, device="meta", policy=pol)
    pj = jax.eval_shape(lambda: JM.init_paged_cache(cfg_j, B, 32, 8,
                                                    policy=pol_j))
    axes = (M.decode_cache_batch_axes(cfg, pol),
            M.decode_cache_seq_axes(cfg, pol))
    axes_j = (JM.decode_cache_batch_axes(cfg_j, pol_j),
              JM.decode_cache_seq_axes(cfg_j, pol_j))
    return ct, cj, pt, pj, axes, axes_j


@pytest.mark.parametrize("kv", quant.KV_DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, kv):
    for mesh in MESHES.values():
        m, mj = _meshes(mesh)
        # B 4 splits over the data axis of (2, 2); B 3 and 1 replicate
        for B, S in ((4, 32), (3, 32), (1, 512)):
            ct, cj, pt, pj, axes, axes_j = _caches(arch, kv, B=B, S=S)
            _assert_same(rules.cache_specs(ct, m, batch=B, seq=S),
                         jrules.cache_specs(cj, mj, batch=B, seq=S))
            _assert_same(
                rules.paged_cache_specs(pt, m, batch_axes=axes[0],
                                        seq_axes=axes[1]),
                jrules.paged_cache_specs(pj, mj, batch_axes=axes_j[0],
                                         seq_axes=axes_j[1]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_fleet_specs_match_reference(mesh):
    m, mj = _meshes(MESHES[mesh])
    for B in (1, 3, 4, 32):
        bt = {"tokens": torch.zeros((B, 8), dtype=torch.int32),
              "labels": torch.zeros((B, 8), dtype=torch.int32),
              "mask": torch.zeros((B, 8)), "scalar": torch.zeros(())}
        bj = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
        _assert_same(rules.batch_spec(bt, m), jrules.batch_spec(bj, mj))
    for hosts in (1, 2, 4):
        fm, fj = (rules.abstract_mesh((hosts,), ("hosts",)),
                  jrules.abstract_mesh((hosts,), ("hosts",)))
        tree = {"w": torch.zeros((8, 3, 2)), "lane": torch.zeros((6,)),
                "odd": torch.zeros((3, 4)), "s": torch.zeros(())}
        tj = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
        _assert_same(rules.fleet_specs(tree, fm), jrules.fleet_specs(tj, fj))


def test_decode_mesh_shape_matches_reference():
    for n in range(1, 9):
        assert LM.decode_mesh_shape(n) == jmesh.decode_mesh_shape(n)


def test_data_axes_and_abstract_mesh():
    m3 = rules.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    j3 = jrules.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.data_axes_of(m3) == jrules.data_axes_of(j3)
    assert m3.size == 512 and m3.shape == dict(j3.shape)
    pt, pj = _params("deepseek-v3-671b")
    _assert_same(rules.param_specs(pt, m3), jrules.param_specs(pj, j3))


def test_block_cuts_the_ranks_expert_block():
    """``block`` under the a2a layout (experts over "model") and ep_all's
    (over both axes, data major), stacked group axis in front."""
    x = torch.arange(2 * 8 * 3 * 5).reshape(2, 8, 3, 5)
    m = rules.abstract_mesh((2, 2), NAMES)
    a2a = rules.leaf_spec("blocks/sub0/moe/wi_gate", x, m, fsdp=False)
    every = rules.leaf_spec("blocks/sub0/moe/wi_gate", x, m, fsdp=False,
                            ep_all=True)
    assert a2a == (None, "model", None, None)
    assert every == (None, ("data", "model"), None, None)
    for d in range(2):
        for k in range(2):
            c = {"data": d, "model": k}
            assert torch.equal(rules.block(x, a2a, m, c), x[:, 4 * k:4 * k + 4])
            r = 2 * d + k
            assert torch.equal(rules.block(x, every, m, c),
                               x[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="does not split"):
        rules.block(torch.zeros(2, 3, 3, 5), a2a, m, {"data": 0, "model": 0})
    assert np.array_equal(rules.block(x, (None,) * 4, m, {}).numpy(),
                          x.numpy())
