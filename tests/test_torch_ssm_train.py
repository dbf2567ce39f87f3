"""Training of the port's ssm family (Mamba-2) against the JAX reference.

The reference trains through XLA's autodiff of ``ssd_chunked`` (its
Pallas scan has no VJP), so it runs with ``use_pallas=False``.  The port
runs both of its paths: ``use_kernels=True`` (the scan's wrapper, whose
CPU tensors take the plain version ``ref.ssd_scan_ref`` under autograd;
on the card the kernel's ``_SSD`` Function, whose backward is
``ops.ssd_bwd``) and ``use_kernels=False`` (``ssd_chunked``).

* ``ops.ssd_bwd`` against ``jax.vjp`` of the reference's
  ``ssd_chunked``, with cotangents on y and on the final state: one
  group and two groups of two heads (B/C given per group, their
  gradients summed over each group's heads), an ``init_state``, S not a
  multiple of the chunk, and slow decay (dt·|A| about 0.005, where the
  carried state and the far pairs of a chunk reach y); ``_SSD``'s
  plumbing on the CPU, its forward swapped for the plain version.
  Planted faults must break the check: a dropped group sum, dA's
  gradient skipping the reverse cumsum, a lost ``init_state`` gradient.
* Reduced Mamba2 (2 layers, d 128, N 16, P 16, chunk 32, f32; the
  reference's init and the same with slow decay): ``loss_fn`` and every
  gradient against ``jax.grad`` of the reference's, with remat off and
  on (each block rematerialised); 4 ``train_device`` steps' losses and
  final parameters.

Tolerances, set from readings (f32 sums in other orders): ``ssd_bwd``
each gradient within 2e-5 of its largest element (readings up to
2.6e-6); losses 1e-5 relative (readings up to 1.6e-7); gradients within
2e-5 of each leaf's largest element (readings up to 3.9e-6); parameters
after 4 AdamW steps 1e-5 absolute + 1e-4 relative, as
``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.federated import FederatedCorpus as JCorpus
from repro.federated import device as jdev
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated import device as tdev
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import model as M

from test_torch_simulation import fast_reference_compiles

BWD_REL = 2e-5
LOSS_RTOL = 1e-5
GRAD_REL = 2e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _fast_reference():
    with fast_reference_compiles():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel_err(got, want):
    """Largest |got - want| over the largest |want| (a missing gradient
    counts as zero)."""
    want = _np(want)
    got = np.zeros_like(want) if got is None else _np(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# ssd_bwd against jax.vjp of the reference's ssd_chunked
# ---------------------------------------------------------------------------

# (B, S, H, P, N, G, chunk, with init_state, slow decay)
SCAN_CASES = {
    "one_group": (2, 48, 4, 8, 8, 1, 16, False, False),
    "two_groups": (2, 48, 4, 8, 8, 2, 16, False, False),
    "init_state": (2, 48, 4, 8, 8, 1, 16, True, False),
    "ragged": (1, 45, 4, 8, 8, 2, 16, True, False),
    "slow": (2, 45, 4, 8, 8, 2, 16, True, True),
}


def _scan_inputs(case, seed=0):
    B, S, H, P, N, G, chunk, h0, slow = SCAN_CASES[case]
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    b = (0.5 * rng.standard_normal((B, S, G, N))).astype(f)
    c = (0.5 * rng.standard_normal((B, S, G, N))).astype(f)
    if slow:
        dt = (0.05 + 0.1 * rng.random((B, S, H))).astype(f)
        A = -(0.02 + 0.05 * rng.random(H)).astype(f)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
        A = -np.ones(H, f)
    init = (0.5 * rng.standard_normal((B, H, P, N))).astype(f) if h0 \
        else None
    dy = rng.standard_normal((B, S, H, P)).astype(f)
    dh = rng.standard_normal((B, H, P, N)).astype(f)
    return (x, dt, A, b, c, init), dy, dh, chunk


def _jax_vjp(inputs, dy, dh, chunk):
    """Gradients of the reference's ``ssd_chunked`` (B/C repeated to H
    heads inside the differentiated function, as its model does)."""
    x, dt, A, b, c, init = inputs
    H = x.shape[2]

    def f(x, dt, A, b, c, init):
        return jssm.ssd_chunked(x, dt, A, jssm._expand_groups(b, H),
                                jssm._expand_groups(c, H), chunk=chunk,
                                init_state=init)

    args = [jnp.asarray(a) for a in (x, dt, A, b, c)]
    if init is None:
        (y, h), vjp = jax.vjp(lambda *a: f(*a, None), *args)
        grads = vjp((jnp.asarray(dy), jnp.asarray(dh))) + (None,)
    else:
        (y, h), vjp = jax.vjp(f, *args, jnp.asarray(init))
        grads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    return (y, h), grads


def _port_bwd(inputs, dy, dh, chunk):
    saved = [None if a is None else torch.from_numpy(a) for a in inputs]
    return ops.ssd_bwd(saved, torch.from_numpy(dy), torch.from_numpy(dh),
                       chunk=chunk)


def _worst(got, want):
    return max(_rel_err(g, w) for g, w in zip(got, want) if w is not None)


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_ssd_bwd_matches_reference_vjp(case):
    inputs, dy, dh, chunk = _scan_inputs(case)
    (yj, hj), want = _jax_vjp(inputs, dy, dh, chunk)
    got = _port_bwd(inputs, dy, dh, chunk)
    assert (got[5] is None) == (inputs[5] is None)
    for g, w, a in zip(got, want, inputs):
        if a is not None:
            assert tuple(g.shape) == a.shape and g.dtype == torch.float32
    assert _worst(got, want) <= BWD_REL
    # the forward the backward differentiates is the reference's too
    y, h = ref.ssd_scan_ref(*[None if a is None else torch.from_numpy(a)
                              for a in inputs[:5]], chunk=chunk,
                            init_state=None if inputs[5] is None
                            else torch.from_numpy(inputs[5]))
    np.testing.assert_allclose(_np(y), _np(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(h), _np(hj), atol=1e-5, rtol=1e-5)


def test_slow_case_shows_every_term():
    """In the slow case the far pairs of a chunk and the carried state
    each make at least 10% of |y|, so the gradient check sees them."""
    inputs, _, _, chunk = _scan_inputs("slow")
    t = [None if a is None else torch.from_numpy(a) for a in inputs]
    near, far, inter = ref.ssd_terms(*t[:5], chunk=chunk, init_state=t[5],
                                     far=4)
    intra = near.abs() + far.abs()
    assert (far.abs().sum() / intra.sum()).item() >= 0.1
    assert (inter.abs().sum() / (intra + inter.abs()).sum()).item() >= 0.1


def test_autograd_function_routes_ssd_bwd(monkeypatch):
    """``_SSD`` (the card's path) with its kernel swapped for the plain
    version: the loss of y alone (the final state unused, its cotangent
    zero) and of both, gradients of every input against ``jax.vjp``;
    ``init_state`` absent gets no gradient."""
    monkeypatch.setattr(ops, "_ssd_fwd", lambda *a, chunk, init_state:
                        ref.ssd_scan_ref(*a, chunk=chunk,
                                         init_state=init_state))
    for case in ("two_groups", "slow"):
        inputs, dy, dh, chunk = _scan_inputs(case, seed=1)
        for use_h in (False, True):
            ts = [None if a is None else torch.from_numpy(a).requires_grad_()
                  for a in inputs]
            y, h = ops._SSD.apply(*ts, chunk)
            loss = (y * torch.from_numpy(dy)).sum()
            if use_h:
                loss = loss + (h * torch.from_numpy(dh)).sum()
            loss.backward()
            _, want = _jax_vjp(inputs, dy, dh if use_h else 0 * dh, chunk)
            assert _worst([None if t is None else t.grad for t in ts],
                          want) <= BWD_REL


class _CumsumNoReverse(torch.autograd.Function):
    """cumsum whose backward passes the cotangent straight through, as if
    dA entered cum without the cumsum."""

    @staticmethod
    def forward(ctx, x, dim, cumsum):
        return cumsum(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _one_head_a_group(t, H):
    """Group expansion whose backward takes only the first head of each
    group: the group sum dropped."""
    G = t.shape[2]
    if G == H:
        return t
    r = H // G
    parts = []
    for g in range(G):
        one = t[:, :, g:g + 1]
        parts += [one] + [one.detach()] * (r - 1)
    return torch.cat(parts, 2)


@pytest.mark.parametrize("fault", ["group_sum", "cumsum", "init_state"])
def test_planted_backward_faults_break_the_check(fault, monkeypatch):
    inputs, dy, dh, chunk = _scan_inputs("slow")
    _, want = _jax_vjp(inputs, dy, dh, chunk)
    assert _worst(_port_bwd(inputs, dy, dh, chunk), want) <= BWD_REL
    if fault == "group_sum":
        monkeypatch.setattr(ref, "expand_groups", _one_head_a_group)
    elif fault == "cumsum":
        real = torch.cumsum
        monkeypatch.setattr(torch, "cumsum", lambda x, dim: _CumsumNoReverse
                            .apply(x, dim, real))
    else:
        # the carried-in state enters the recompute cut off from its
        # gradient (zero)
        own = ops.ssd_scan_ref
        monkeypatch.setattr(ops, "ssd_scan_ref", lambda *a, chunk,
                            init_state: own(*a, chunk=chunk, init_state=(
                                init_state.detach() + 0 * init_state)))
    assert _worst(_port_bwd(inputs, dy, dh, chunk), want) > 10 * BWD_REL


# ---------------------------------------------------------------------------
# reduced Mamba2: loss_fn, gradients, train_device
# ---------------------------------------------------------------------------

def _slow(np_tree):
    """A = -0.05, dt = softplus(proj - 4) (about 0.02) in every layer."""
    mixer = np_tree["blocks"]["mixer"]
    mixer["A_log"] = np.full_like(mixer["A_log"], np.log(0.05))
    mixer["dt_bias"] = np.full_like(mixer["dt_bias"], -4.0)
    return np_tree


_MODELS = {}


def models(weights):
    if weights not in _MODELS:
        cfg_j = jax_config("mamba2-1.3b", variant="reduced").replace(
            use_pallas=False)
        cfg = get_config("mamba2-1.3b", variant="reduced")
        tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1),
                                                       cfg_j))
        if weights == "slow":
            tree = _slow(tree)
        _MODELS[weights] = (cfg_j, jax.tree.map(jnp.asarray, tree), cfg,
                            convert.params_from_jax(tree, cfg))
    return _MODELS[weights]


def _batch(cfg, B=2, S=70, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return {"tokens": toks, "labels": labels, "mask": mask}


def _loss_and_grads(cfg, params, batch):
    paths = list(convert.flatten(params))
    leaves = [convert.flatten(params)[p].requires_grad_(True) for p in paths]
    loss, metrics = M.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.item(), metrics, dict(zip(paths, grads))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("weights", ["init", "slow"])
def test_loss_and_every_gradient_match_reference(weights, use_kernels,
                                                 remat):
    cfg_j, pj, cfg, pt = models(weights)
    batch = _batch(cfg)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(pj)
    lt, mt, gt = _loss_and_grads(
        cfg.replace(use_kernels=use_kernels, remat=remat), pt, batch)
    np.testing.assert_allclose(lt, float(lj), rtol=LOSS_RTOL)
    for k in ("nll", "tokens", "accuracy", "ce_loss"):
        np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(gt) == set(want)
    for k, w in want.items():
        assert _rel_err(gt[k], w) <= GRAD_REL, k


def test_train_device_matches_reference():
    """4 steps, batch 2, seq 40, lr 3e-3, from the reference's init
    converted: per-step losses and final parameters."""
    cfg_j, _, cfg, _ = models("init")
    cfg = cfg.replace(remat=True)
    kw = dict(seed=0, n_devices=3, n_domains=2, vocab=cfg.vocab_size)
    cj, ct = JCorpus.build(**kw), FederatedCorpus.build(**kw)
    seed, dev_id = 1, 2
    run = dict(steps=4, batch=2, seq_len=40, lr=3e-3, seed=seed)
    up_j = jdev.train_device(jdev.DeviceSpec(dev_id, cfg_j, 0, 1), cj, **run)
    init = JM.init_params(jax.random.PRNGKey(seed * 100003 + dev_id), cfg_j)
    up_t = tdev.train_device(
        tdev.DeviceSpec(dev_id, cfg, 0, 1), ct, device="cpu",
        params=convert.params_from_jax(jax.tree.map(np.asarray, init), cfg),
        **run)
    np.testing.assert_allclose(up_t["losses"], up_j["losses"],
                               rtol=LOSS_RTOL)
    assert up_t["losses"][-1] < up_t["losses"][0]
    want = convert.flatten(jax.tree.map(np.asarray, up_j["params"]))
    got = convert.flatten(up_t["params"])
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], **PARAM_TOL,
                                   err_msg=k)


def test_launcher_trains_mamba2_on_the_cpu():
    from repro_torch.launch import train
    losses = train.main(["--arch", "mamba2-1.3b", "--variant", "reduced",
                         "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "32"])
    assert len(losses) == 3 and all(np.isfinite(losses))
