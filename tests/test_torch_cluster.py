"""Phase I of the port (embedding clustering, proxy models) against the
JAX reference, on the CPU.

Clustering is numpy in both packages (the port keeps its own copy), so
labels, centroids, similarity and members must be bit-identical: across
seeds, with architecture constraints that force a spill cluster, with
an empty cluster re-seeded, and with fewer devices than clusters.
Proxies average in f32 in member order and cast back, in both packages,
so they must be bit-identical in f32 and in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclust
from repro.core import proxy as jproxy
from repro_torch import convert
from repro_torch.core import clustering, proxy
from repro_torch.data.federated import FederatedCorpus
from repro_torch.models import model as M

from test_torch_train import device_families, port_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and more oversubscribe a CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(got, want):
    for f in ("labels", "centroids", "similarity"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.members == want.members


def _embeddings(seed, n=12, dim=32):
    corpus = FederatedCorpus.build(seed=seed, n_devices=n, n_domains=4,
                                   vocab=64)
    return np.stack([corpus.device_embedding(i, dim) for i in range(n)])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_devices_bit_identical_across_seeds(seed):
    e = _embeddings(seed)
    arch = [(i * 7 + seed) % 2 for i in range(len(e))]
    for k in (2, 4, 5):
        for arch_ids in (None, arch):
            _assert_same(clustering.cluster_devices(e, k, arch_ids=arch_ids,
                                                    seed=seed),
                         jclust.cluster_devices(e, k, arch_ids=arch_ids,
                                                seed=seed))


def test_spill_cluster_bit_identical():
    """Three tight groups of arch-0 devices, one arch-1 device inside
    each, K = 3.  No cluster's majority is arch 1, so the first arch-1
    device seeds a spill cluster in the emptiest slot and the others
    join it."""
    rng = np.random.default_rng(5)
    centers = np.eye(3, 16, dtype=np.float32)
    e = np.concatenate([centers[i] + 0.01 * rng.standard_normal((4, 16))
                        for i in range(3)]).astype(np.float32)
    arch = [0, 0, 0, 1] * 3
    got = clustering.cluster_devices(e, 3, arch_ids=arch, seed=0)
    _assert_same(got, jclust.cluster_devices(e, 3, arch_ids=arch, seed=0))
    spill = [m for m in got.members if m and {arch[i] for i in m} == {1}]
    assert spill == [[3, 7, 11]]


def test_empty_cluster_reseed_bit_identical():
    """Two distinct points, duplicated, and K = 4: k-means++ draws
    duplicate centroids, whose clusters come out empty and are re-seeded
    at the farthest point."""
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((2, 8)).astype(np.float32)
    e = np.repeat(pts, 3, axis=0)
    for seed in range(3):
        labels, cents = clustering.spherical_kmeans(e, 4, seed=seed)
        jl, jc = jclust.spherical_kmeans(e, 4, seed=seed)
        np.testing.assert_array_equal(labels, jl)
        np.testing.assert_array_equal(cents, jc)
        assert len(set(labels.tolist())) <= 2 < 4
        _assert_same(clustering.cluster_devices(e, 4, seed=seed),
                     jclust.cluster_devices(e, 4, seed=seed))


def test_fewer_devices_than_clusters():
    """N = 2 uploads, K = 60 (the full MoE's expert count): k = N, and
    each upload is its own cluster."""
    e = _embeddings(0, n=2)
    for arch in ([0, 0], [0, 1]):
        got = clustering.cluster_devices(e, 60, arch_ids=arch, seed=0)
        _assert_same(got, jclust.cluster_devices(e, 60, arch_ids=arch,
                                                 seed=0))
        assert got.centroids.shape == (2, e.shape[1])
        assert sorted(got.members) == [[0], [1]]


def _uploads(dtype):
    """Four devices of the two benchmark families (0, 1, 0, 1), port
    parameters and their JAX copies."""
    cfgs = [port_cfg(c).replace(dtype=dtype) for c in device_families()]
    pt, pj = [], []
    for i in range(4):
        cfg = cfgs[i % 2]
        p = M.init_params(cfg, generator=torch.Generator().manual_seed(i))
        pt.append(p)
        pj.append(jax.tree.map(jnp.asarray, convert.params_to_jax(p, cfg)))
    return cfgs, pt, pj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_proxies_bit_identical(dtype):
    cfgs, pt, pj = _uploads(dtype)
    arch = [0, 1, 0, 1]
    res = clustering.ClusterResult(
        labels=np.array([0, 1, 0, 2]), centroids=np.zeros((4, 4)),
        similarity=np.ones((4, 4)), members=[[0, 2], [1], [3], []])
    got = proxy.build_proxies(pt, res, arch)
    want = jproxy.build_proxies(pj, res, arch)
    assert [(p["members"], p["arch"], p["cluster"]) for p in got] == \
        [(p["members"], p["arch"], p["cluster"]) for p in want] == \
        [([0, 2], 0, 0), ([1], 1, 1), ([3], 1, 2)]
    for g, w in zip(got, want):
        cfg = cfgs[g["arch"]]
        back = convert.flatten(convert.params_to_jax(g["params"], cfg))
        for k, v in convert.flatten(jax.tree.map(np.asarray,
                                                 w["params"])).items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k].view(np.uint8),
                                          v.view(np.uint8), err_msg=k)
    # a one-member cluster's proxy is the upload itself
    assert got[1]["params"] is pt[1]
    # the average is a true average: f32 sum of the two, divided, cast
    emb = got[0]["params"]["embed"]
    want_emb = ((pt[0]["embed"].float() + pt[2]["embed"].float()) / 2).to(
        emb.dtype)
    assert torch.equal(emb, want_emb)


def test_mixed_arch_cluster_raises():
    _, pt, pj = _uploads("float32")
    res = clustering.ClusterResult(
        labels=np.array([0, 0]), centroids=np.zeros((1, 4)),
        similarity=np.ones((2, 2)), members=[[0, 1]])
    with pytest.raises(ValueError, match="mixes architectures"):
        proxy.build_proxies(pt[:2], res, [0, 1])
    with pytest.raises(AssertionError):
        jproxy.build_proxies(pj[:2], res, [0, 1])
