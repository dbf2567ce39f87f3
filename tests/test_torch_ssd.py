"""The SSD chunked scan of the port against the JAX reference.

The port's ``kernels/ssd_scan/ops.ssd`` on CPU tensors (its plain
version, ``ref.py``) against the reference's ``ssd_scan.ops.ssd`` (the
Pallas kernel in interpret mode) and its sequential oracle ``ssd_ref``,
and the port's ``models/ssm.ssd_chunked`` against the reference's, on
the same numpy inputs: S a multiple of the chunk, ragged, shorter than a
chunk, an initial state, two groups, and slow decay.

The reference's init decays fast (A = -1, dt about 0.75: a 32-row chunk
decays by about e^-24), so the far pairs of a chunk, the carried state
and the initial state barely reach y.  The slow-decay cases keep
exp(cum) over a chunk above 1e-2, and check with ``ssd_terms`` that
each of those terms carries at least 10% of its part of |y| there.

Tolerance: f32 throughout, sums and the cumsum in another order, so y
and the final state are held to 2e-5 of the case's largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref
from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (expand_groups, ssd_scan_ref,
                                             ssd_terms)
from repro_torch.models import ssm

REL = 2e-5

# name: (B, S, H, P, N, G, chunk, with h0, slow decay)
CASES = {
    "multiple": (2, 64, 4, 8, 16, 1, 32, False, False),
    "ragged": (2, 100, 3, 8, 16, 1, 32, False, False),
    "shorter_than_chunk": (1, 37, 2, 8, 8, 1, 64, False, False),
    "init_state": (1, 50, 2, 8, 8, 1, 16, True, False),
    "two_groups": (2, 45, 4, 16, 16, 2, 32, False, False),
    "slow_decay": (1, 96, 2, 16, 16, 1, 32, False, True),
    "slow_decay_ragged_groups_h0": (2, 100, 4, 8, 16, 2, 32, True, True),
}


def _inputs(case, seed=0):
    B, S, H, P, N, G, chunk, with_h0, slow = CASES[case]
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    if slow:   # dt * |A| <= 0.01: a 32-row chunk decays by at most e^-0.32
        dt = rng.uniform(0.02, 0.1, (B, S, H)).astype(f)
        A = -rng.uniform(0.02, 0.1, (H,)).astype(f)
    else:      # as the reference's test: dt ~ softplus(N(0,1)), A ~ -1
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
        A = -np.exp(rng.standard_normal((H,)) * 0.3).astype(f)
    b = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    c = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(f) if with_h0 \
        else None
    return dict(x=x, dt=dt, A=A, b=b, c=c, h0=h0, chunk=chunk, G=G, H=H)


def _per_head(a, H):
    return np.repeat(a, H // a.shape[2], axis=2)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def _jax_ssd(i):
    H = i["H"]
    return jops.ssd(jnp.asarray(i["x"]), jnp.asarray(i["dt"]),
                    jnp.asarray(i["A"]), jnp.asarray(_per_head(i["b"], H)),
                    jnp.asarray(_per_head(i["c"], H)), chunk=i["chunk"],
                    init_state=None if i["h0"] is None
                    else jnp.asarray(i["h0"]))


def _jax_sequential(i):
    B, S, H, P = i["x"].shape
    N = i["b"].shape[-1]

    def bh(a):  # (B, S, H, ...) -> (B*H, S, ...)
        a = _per_head(a, H) if a.ndim == 4 and a.shape[2] != H else a
        return jnp.asarray(np.moveaxis(a, 2, 1).reshape((B * H, S)
                                                        + a.shape[3:]))
    y, h = jssd_ref(bh(i["x"]), bh(i["dt"]), jnp.tile(jnp.asarray(i["A"]), B),
                    bh(i["b"]), bh(i["c"]),
                    h0=None if i["h0"] is None
                    else jnp.asarray(i["h0"].reshape(B * H, P, N)))
    return (np.moveaxis(np.asarray(y).reshape(B, H, S, P), 1, 2),
            np.asarray(h).reshape(B, H, P, N))


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_matches_reference_kernel_and_oracle(case):
    i = _inputs(case)
    y, h = ops.ssd(_t(i["x"]), _t(i["dt"]), _t(i["A"]), _t(i["b"]),
                   _t(i["c"]), chunk=i["chunk"], init_state=_t(i["h0"]))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    yj, hj = _jax_ssd(i)
    _close(y.numpy(), yj, "y vs Pallas kernel")
    _close(h.numpy(), hj, "state vs Pallas kernel")
    ys, hs = _jax_sequential(i)
    _close(y.numpy(), ys, "y vs sequential oracle")
    _close(h.numpy(), hs, "state vs sequential oracle")


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_chunked_matches_reference(case):
    i = _inputs(case, seed=1)
    H = i["H"]
    kw = dict(chunk=i["chunk"])
    y, h = ssm.ssd_chunked(_t(i["x"]), _t(i["dt"]), _t(i["A"]),
                           _t(_per_head(i["b"], H)), _t(_per_head(i["c"], H)),
                           init_state=_t(i["h0"]), **kw)
    yj, hj = jssm.ssd_chunked(
        jnp.asarray(i["x"]), jnp.asarray(i["dt"]), jnp.asarray(i["A"]),
        jnp.asarray(_per_head(i["b"], H)), jnp.asarray(_per_head(i["c"], H)),
        init_state=None if i["h0"] is None else jnp.asarray(i["h0"]), **kw)
    _close(y.numpy(), yj, "y")
    _close(h.numpy(), hj, "state")


def test_ssd_chunked_bf16_operands_match_reference():
    """compute_dtype=bf16: the matrix operands rounded to bf16 at the
    reference's points, products exact in f32."""
    i = _inputs("slow_decay_ragged_groups_h0", seed=2)
    H = i["H"]
    args = (i["x"], i["dt"], i["A"], _per_head(i["b"], H),
            _per_head(i["c"], H))
    y, h = ssm.ssd_chunked(*map(_t, args), chunk=i["chunk"],
                           init_state=_t(i["h0"]),
                           compute_dtype=torch.bfloat16)
    yj, hj = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=i["chunk"],
                              init_state=jnp.asarray(i["h0"]),
                              compute_dtype=jnp.bfloat16)
    _close(y.numpy(), yj, "y")
    _close(h.numpy(), hj, "state")


def term_shares(x, dt, A, b, c, *, chunk, init_state=None):
    """(far-pair share of the intra-chunk term, carried-state share of
    |y| over the chunks after the first, the same over the first chunk)
    of f32 tensors, far meaning more than a quarter chunk apart."""
    near, far, inter = ssd_terms(x, dt, A, b, c, chunk=chunk,
                                 init_state=init_state, far=chunk // 4)
    later = slice(chunk, None)  # the chunks after the first
    intra = near.abs() + far.abs()
    tot = intra + inter.abs()
    return (float(far.abs().sum() / intra.sum()),
            float(inter[:, later].abs().sum() / tot[:, later].sum()),
            float(inter[:, :chunk].abs().sum() / tot[:, :chunk].sum()))


def test_slow_decay_cases_see_every_term():
    """Where decay is slow, the far pairs carry at least 10% of the
    intra-chunk term, and the state carried into the later chunks (and
    h0 into the first) at least 10% of |y|."""
    def shares(case):
        i = _inputs(case)
        return term_shares(_t(i["x"]), _t(i["dt"]), _t(i["A"]), _t(i["b"]),
                           _t(i["c"]), chunk=i["chunk"],
                           init_state=_t(i["h0"]))
    far, carried, first = shares("slow_decay_ragged_groups_h0")
    assert far >= 0.1 and carried >= 0.1 and first >= 0.1, (far, carried,
                                                            first)
    far, carried, _ = shares("slow_decay")
    assert far >= 0.1 and carried >= 0.1, (far, carried)


def test_ssd_reads_group_tensors_and_expanded_views():
    """B/C per group, per head, or as a zero-stride expanded view: one
    result."""
    i = _inputs("two_groups")
    H = i["H"]
    want = ops.ssd(_t(i["x"]), _t(i["dt"]), _t(i["A"]),
                   _t(_per_head(i["b"], H)), _t(_per_head(i["c"], H)),
                   chunk=i["chunk"])
    got = ops.ssd(_t(i["x"]), _t(i["dt"]), _t(i["A"]), _t(i["b"]),
                  _t(i["c"]), chunk=i["chunk"])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    one = {k: v[:, :, :1] for k, v in (("b", i["b"]), ("c", i["c"]))}
    views = [_t(one[k]).expand(-1, -1, H, -1) for k in ("b", "c")]
    assert views[0].stride(2) == 0
    a = ops.ssd(_t(i["x"]), _t(i["dt"]), _t(i["A"]), *views, chunk=i["chunk"])
    b = ops.ssd(_t(i["x"]), _t(i["dt"]), _t(i["A"]), _t(one["b"]),
                _t(one["c"]), chunk=i["chunk"])
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, atol=0, rtol=0)
    assert expand_groups(_t(i["b"]), H).shape == (2, 45, H, 16)


def test_ssd_rounds_y_to_x_dtype():
    i = _inputs("ragged")
    xb = _t(i["x"]).bfloat16()
    bb, cb = (_t(i[k]).bfloat16() for k in ("b", "c"))
    y, h = ops.ssd(xb, _t(i["dt"]), _t(i["A"]), bb, cb, chunk=i["chunk"])
    y32, h32 = ops.ssd(xb.float(), _t(i["dt"]), _t(i["A"]), bb.float(),
                       cb.float(), chunk=i["chunk"])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y, y32.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(h, h32, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "groups"])
def test_ssd_refuses_what_it_does_not_take(bad):
    i = _inputs("two_groups")
    args = [_t(i[k]) for k in ("x", "dt", "A", "b", "c")]
    if bad == "shape":
        args[1] = args[1][:, :-1]
        err = ValueError
    elif bad == "dtype":
        args[1] = args[1].double()
        err = TypeError
    else:
        args[3] = args[4] = torch.zeros(2, 45, 3, 16)
        err = ValueError
    with pytest.raises(err):
        ops.ssd(*args, chunk=i["chunk"])


def test_plain_version_runs_in_f64():
    """f64 inputs keep the plain version in f64 (a more exact oracle for
    the on-card checks); it agrees with the f32 run."""
    i = _inputs("slow_decay_ragged_groups_h0")
    args = [_t(i[k]) for k in ("x", "dt", "A", "b", "c")]
    y64, h64 = ssd_scan_ref(*(a.double() for a in args), chunk=i["chunk"],
                            init_state=_t(i["h0"]).double())
    y, h = ops.ssd(*args, chunk=i["chunk"], init_state=_t(i["h0"]))
    assert y64.dtype == h64.dtype == torch.float64
    _close(y.numpy(), y64.numpy(), "y")
    _close(h.numpy(), h64.numpy(), "state")


@pytest.mark.parametrize("P,N,dtype,pad,want", [
    (64, 128, torch.bfloat16, 0, "tc"),       # the ssm prefill's views
    (64, 128, torch.bfloat16, 1, "general"),  # an odd row stride
    (24, 128, torch.bfloat16, 0, "general"),  # P not a multiple of 16
    (64, 40, torch.bfloat16, 0, "general"),   # N not a multiple of 16
    (64, 272, torch.bfloat16, 0, "general"),  # N over the tc tiles' 256
    (64, 128, torch.float32, 0, "f32")])
def test_instance_is_picked_from_dtype_shapes_and_strides(P, N, dtype, pad,
                                                          want):
    """The kernel's instance follows from the tensors alone: x, B and C as
    views of one (B, S, H*P + 2*N + pad) conv output, as the model passes
    them."""
    H = 4
    conv = torch.zeros(1, 40, H * P + 2 * N + pad, dtype=dtype)
    x = conv[..., :H * P].reshape(1, 40, H, P)
    b = conv[..., H * P:H * P + N].reshape(1, 40, 1, N)
    c = conv[..., H * P + N:H * P + 2 * N].reshape(1, 40, 1, N)
    assert ops.instance(x, b, c) == want
