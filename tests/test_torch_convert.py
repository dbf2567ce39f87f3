"""The weight bridge between the JAX reference and the PyTorch port."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.utils.pytree import flatten_with_paths
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_exact(dtype):
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced").replace(
        dtype=dtype)
    cfg = get_config("tinyllama-1.1b", variant="reduced").replace(dtype=dtype)
    params = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params)
    tp = convert.params_from_jax(tree, cfg)
    # same /-joined paths as the reference's pytree helper, same layout
    want = {p: np.asarray(l) for p, l in flatten_with_paths(params)}
    got = convert.flatten(tp)
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape
        assert t.dtype == getattr(torch, dtype)
    back = convert.flatten(convert.params_to_jax(tp, cfg))
    for path, a in want.items():
        assert back[path].dtype == a.dtype
        np.testing.assert_array_equal(back[path].view(np.uint8),
                                      a.view(np.uint8))


def test_layout_matches_port_init():
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    jax_tree = jax.tree.map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                   jax_config("tinyllama-1.1b",
                                              variant="reduced")))
    port = convert.flatten(M.init_params(
        cfg, generator=torch.Generator().manual_seed(0)))
    ref = convert.flatten(jax_tree)
    assert {p: tuple(t.shape) for p, t in port.items()} == \
        {p: a.shape for p, a in ref.items()}
    # the stacked group axis leads every block leaf
    assert port["blocks/sub0/attn/wq"].shape[0] == cfg.n_layers


def _tree():
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced")
    return jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(0), cfg_j))


def test_shape_mismatch_raises():
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    tree = _tree()
    tree["blocks"]["sub0"]["attn"]["wq"] = tree["blocks"]["sub0"]["attn"][
        "wq"][:, :, :-1]
    with pytest.raises(ValueError, match="blocks/sub0/attn/wq"):
        convert.params_from_jax(tree, cfg)


def test_dtype_mismatch_raises():
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    tree = _tree()
    tree["embed"] = tree["embed"].astype(np.float16)
    with pytest.raises(TypeError, match="embed"):
        convert.params_from_jax(tree, cfg)


def test_path_mismatch_raises():
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    tree = _tree()
    del tree["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_jax(tree, cfg)
