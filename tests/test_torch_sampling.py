"""The port's samplers and their random stream, on the CPU.

``jax.random`` and the port's stream never agree, so the samplers are
held on injected uniforms and on their distributions, not on the JAX
package's tokens:

* the greedy limits (``Temperature(0)``, ``1e-6``, ``TopK(k, 0)``),
  ``TopK``'s k clamped to V, ``verify``'s greedy limits (as the
  reference's tests);
* ``Stream.bits`` equal to the same hash in Python integers, and its
  uniforms in (0, 1), the largest hash included: an all-ones hash emits
  no masked token; the decisions on injected uniforms equal to a numpy
  version of the same rules;
* ``_residual_verify``'s emitted marginal equal to the target within
  ``MARGINAL_ATOL``, its acceptance rate p(draft), no rejection emitting
  the draft, for a modal and a rare draft; always accepting, resampling
  without the mask and ``TopK`` without its mask each break it;
  ``Temperature``'s and ``TopK``'s marginals, no mass outside the top k;
* the engines: tokens invariant to ``seg_len`` in both, with and without
  speculation; a paged preemption's replay; the same seed giving the
  same tokens in both engines, another seed other tokens; ``submit(key=)``;
  the launcher's ``--temperature`` and ``--top-k``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, ServeEngine, Temperature, TopK
from repro_torch.serve import sampling as S
from repro_torch.utils import rng as R

# the reference's limit on an empirical marginal of N = 20,000 draws
# (its test_residual_verify_matches_target_distribution)
MARGINAL_ATOL = 0.02
N, T = 20000, 0.8
LOGITS = [1.2, -0.3, 0.7, 2.0, -1.0, 0.1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(n, seed=0, ctr=0):
    return R.Stream.of([R.stream_key(seed, i) for i in range(n)], [ctr] * n,
                       "cpu")


def _target(logits, t, k=None):
    l = np.asarray(logits, np.float64)
    if k is not None:
        l = np.where(l >= np.sort(l)[-k], l, -np.inf)
    e = np.exp(l / t - np.max(l / t))
    return e / e.sum()


# ---------------------------------------------------------------------------
# greedy limits
# ---------------------------------------------------------------------------

def test_zero_temperature_samplers_decode_greedily():
    logits = torch.randn((3, 64), generator=torch.Generator().manual_seed(1)
                         ) * 1e4
    greedy = torch.argmax(logits, -1).to(torch.int32)
    for sampler in (Temperature(0.0), Temperature(1e-6), TopK(8, 0.0)):
        assert torch.equal(sampler(_stream(3), logits), greedy)


def test_topk_clamps_k_to_vocab():
    logits = torch.randn((2, 16), generator=torch.Generator().manual_seed(1))
    out = TopK(k=1000, t=1.0)(_stream(2), logits)
    assert out.shape == (2,) and out.dtype == torch.int32
    assert ((0 <= out) & (out < 16)).all()
    assert torch.equal(TopK(k=1000, t=0.0)(_stream(2), logits),
                       torch.argmax(logits, -1).to(torch.int32))


def test_verify_methods_greedy_limits():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 0.2]])
    draft = torch.tensor([1, 1], dtype=torch.int32)
    for s in (S.Greedy(), Temperature(0.0), TopK(2, 0.0)):
        tok, acc = s.verify(_stream(2), logits, draft)
        assert tok.tolist() == [1, 0] and acc.tolist() == [True, False]


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

def _mix32_int(x):
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_stream_bits_match_the_hash_in_python_integers():
    keys = [R.stream_key(7, uid) for uid in (0, 1, 2**40 + 3)]
    ctr = [0, 5, 2**33 + 9]
    st = R.Stream.of(keys, ctr, "cpu").advance(4).at(3)
    got = st.bits(1, 50).tolist()
    for b, ((k0, k1), c) in enumerate(zip(keys, ctr)):
        row = _mix32_int(k0 ^ _mix32_int(k1 ^ _mix32_int(
            ((c + 4) & 0xFFFFFFFF) ^ _mix32_int((3 << 4) | 1))))
        assert got[b] == [_mix32_int(row ^ _mix32_int(i)) for i in range(50)]
    assert all(0 <= k < 2**32 for key in keys for k in key)
    u = _stream(64).uniform(1, 1000)
    assert u.dtype == torch.float32 and (u > 0).all() and (u < 1).all()
    assert abs(u.mean().item() - 0.5) < 0.01
    # another lane, site or step draws other bits
    base = _stream(4).bits(1, 8)
    for other in (_stream(4).at(1).bits(1, 8), _stream(4).bits(0, 8),
                  _stream(4).advance(1).bits(1, 8), _stream(4, 1).bits(1, 8)):
        assert not torch.equal(base, other)


def test_uniforms_never_round_to_one():
    """The map from hashes to uniforms is monotone, so its ends bound
    every draw: the all-ones hash gives 1 - 2**-24 (exact in f32, where
    2**24 - 0.5 of a 24-bit map would round to 2**24), whose Gumbel
    noise is finite."""
    h = torch.tensor([2**32 - 1, 2**32 - 2**8 - 1, 2**31, 2**9, 1, 0])
    u = R.bits_to_uniform(h)
    assert u.dtype == torch.float32 and (u > 0).all() and (u < 1).all()
    assert u[0].item() == 1 - 2.0 ** -24 and u[-1].item() == 2.0 ** -24
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_all_ones_hash_emits_no_masked_token(monkeypatch):
    """Every draw at the largest uniform: the Gumbel noise is the same
    finite value at every index, so each sampler emits its masked
    target's argmax, never a token outside the top k or a rejected
    draft."""
    monkeypatch.setattr(R.Stream, "bits", lambda self, site, n: torch.full(
        (self.key.shape[0], n), 2**32 - 1, dtype=torch.int64))
    logits = torch.randn((8, 64), generator=torch.Generator().manual_seed(2))
    order = torch.argsort(logits, -1, descending=True).to(torch.int32)
    st = _stream(8)
    assert torch.equal(Temperature(T)(st, logits), order[:, 0])
    assert torch.equal(TopK(5, T)(st, logits), order[:, 0])
    # the modal draft is rejected at u = 1 - 2**-24 (p < 1): the resample
    # is the runner-up; a draft outside the top 5 resamples inside it
    tok, acc = Temperature(T).verify(st, logits, order[:, 0])
    assert not acc.any() and torch.equal(tok, order[:, 1])
    tok, acc = TopK(5, T).verify(st, logits, order[:, 9])
    assert not acc.any() and torch.equal(tok, order[:, 0])


def _np_categorical(u, logits, t):
    g = -np.log(-np.log(u))
    return np.argmax(logits / np.float32(t) + g, -1)


def test_decisions_on_injected_uniforms_match_numpy():
    """``categorical`` is Gumbel-max over logits / t; ``_residual_verify``
    accepts where u < softmax(logits / t)[draft], else draws Gumbel-max
    with the draft masked out: a numpy version of the same rules on the
    same uniforms makes the same decisions."""
    rng = np.random.default_rng(0)
    B, V, t = 300, 12, 0.7
    logits = rng.normal(size=(B, V)).astype(np.float32) * 2
    u_alt = rng.uniform(1e-6, 1 - 1e-6, (B, V)).astype(np.float32)
    u_acc = rng.uniform(0, 1, B).astype(np.float32)
    draft = rng.integers(0, V, B).astype(np.int32)
    tl, ta, tu = (torch.as_tensor(x) for x in (logits, u_alt, u_acc))
    got = S.categorical(ta, tl, t).numpy()
    np.testing.assert_array_equal(got, _np_categorical(u_alt, logits, t))
    tok, acc = S._residual_verify(tu, ta, tl, torch.as_tensor(draft), t)
    p = np.exp(logits / t - logits.max(-1, keepdims=True) / t)
    p /= p.sum(-1, keepdims=True)
    want_acc = u_acc < p[np.arange(B), draft]
    masked = logits.copy()
    masked[np.arange(B), draft] = -np.inf
    want = np.where(want_acc, draft, _np_categorical(u_alt, masked, t))
    assert 0 < want_acc.sum() < B
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_array_equal(tok.numpy(), want)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------

def _check_verify(verify, d, target, outside=()):
    """The emitted marginal of ``verify(stream, logits, draft)`` over N
    rows with draft ``d``: the target within MARGINAL_ATOL, acceptance
    p(d), no rejection emitting d, nothing in ``outside``."""
    logits = torch.tensor(LOGITS).expand(N, -1).contiguous()
    draft = torch.full((N,), d, dtype=torch.int32)
    tok, acc = verify(_stream(N, seed=3), logits, draft)
    tok, acc = tok.numpy(), acc.numpy()
    emp = np.bincount(tok, minlength=len(LOGITS)) / N
    np.testing.assert_allclose(emp, target, atol=MARGINAL_ATOL)
    np.testing.assert_allclose(acc.mean(), target[d], atol=MARGINAL_ATOL)
    assert not np.any(tok[~acc] == d)
    assert not np.isin(tok, outside).any()


@pytest.mark.parametrize("d", [3, 4], ids=["modal", "rare"])
def test_residual_verify_matches_target_distribution(d):
    _check_verify(Temperature(T).verify, d, _target(LOGITS, T))


def test_topk_verify_matches_target_distribution():
    """Top-2 restricts to tokens 3 and 0: a draft outside (2) is always
    rejected and the resample stays inside."""
    target = _target(LOGITS, T, k=2)
    for d in (3, 0, 2):
        _check_verify(TopK(2, T).verify, d, target, outside=[1, 2, 4, 5])


def _always_accept(stream, logits, draft):
    tok, acc = Temperature(T).verify(stream, logits, draft)
    return draft, torch.ones_like(acc)


def _resample_unmasked(stream, logits, draft):
    u_acc = stream.uniform(0, 1)[:, 0]
    accept = u_acc < torch.softmax(logits / T, -1).gather(
        -1, draft.long()[:, None])[:, 0]
    alt = S.categorical(stream.uniform(1, logits.shape[-1]), logits, T)
    return torch.where(accept, draft, alt), accept


@pytest.mark.parametrize("fault", ["always_accept", "resample_unmasked",
                                   "topk_unmasked"])
def test_planted_faults_break_the_check(fault):
    if fault == "topk_unmasked":
        # TopK's target, verified as if no top-k mask existed
        args = (Temperature(T).verify, 2, _target(LOGITS, T, k=2),
                [1, 2, 4, 5])
    else:
        args = ({"always_accept": _always_accept,
                 "resample_unmasked": _resample_unmasked}[fault], 3,
                _target(LOGITS, T))
    with pytest.raises(AssertionError):
        _check_verify(*args)


@pytest.mark.parametrize("sampler,k", [(Temperature(T), None),
                                       (TopK(3, T), 3)], ids=["temp", "topk"])
def test_sampler_marginals(sampler, k):
    logits = torch.tensor(LOGITS).expand(N, -1).contiguous()
    tok = sampler(_stream(N, seed=5), logits).numpy()
    target = _target(LOGITS, T, k)
    np.testing.assert_allclose(np.bincount(tok, minlength=6) / N, target,
                               atol=MARGINAL_ATOL)
    assert (np.bincount(tok, minlength=6)[target == 0] == 0).all()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

TRAFFIC = [(6, 5), (9, 7), (5, 4), (8, 9)]
_MODEL = {}


def _model(n_mtp=0):
    if n_mtp not in _MODEL:
        cfg = get_config("tinyllama-1.1b", variant="reduced").replace(
            n_mtp=n_mtp)
        _MODEL[n_mtp] = (cfg, M.init_params(
            cfg, generator=torch.Generator().manual_seed(1)))
    return _MODEL[n_mtp]


def _serve(cls, sampler, *, n_mtp=0, keys=None, traffic=TRAFFIC,
           one_prompt=False, **kw):
    """Completions of ``traffic`` (random prompts, or with ``one_prompt``
    the first one each time), ``keys`` passed to ``submit``."""
    cfg, params = _model(n_mtp)
    rng = np.random.default_rng(0)
    max_len = max(M.decode_capacity(cfg, p, g) for p, g in traffic)
    eng = cls(params, cfg, n_slots=2, max_len=max_len, sampler=sampler,
              device="cpu", **{"seg_len": 3, **kw})
    prompt = None
    for i, (p, g) in enumerate(traffic):
        if prompt is None or not one_prompt:
            prompt = rng.integers(0, cfg.vocab_size, (1, p))
        eng.submit({"tokens": prompt}, max_new=g,
                   key=None if keys is None else keys[i])
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "speculative"])
@pytest.mark.parametrize("cls", [ServeEngine, PagedServeEngine],
                         ids=["contiguous", "paged"])
def test_sampled_tokens_invariant_to_segment_length(cls, spec):
    kw = dict(n_mtp=spec and 1, speculate=spec, seed=7)
    outs = [_serve(cls, Temperature(T), seg_len=n, **kw)[0] for n in (2, 5)]
    assert outs[0] == outs[1]
    greedy, _ = _serve(cls, None, **kw)
    assert outs[0] != greedy


def test_paged_preemption_replays_the_stream():
    want, _ = _serve(PagedServeEngine, TopK(40, T), block_len=4, seed=2)
    got, eng = _serve(PagedServeEngine, TopK(40, T), block_len=4, seed=2,
                      n_blocks=7)
    assert eng.stats["preemptions"] > 0
    assert got == want


def test_seed_keys_the_tokens_in_both_engines():
    a, _ = _serve(ServeEngine, Temperature(T), seed=11)
    b, _ = _serve(PagedServeEngine, Temperature(T), seed=11, block_len=4)
    c, _ = _serve(ServeEngine, Temperature(T), seed=12)
    assert a == b
    assert a != c


def test_submit_key_seeds_the_stream_in_place_of_the_uid():
    traffic = [(6, 8)] * 2
    same, _ = _serve(ServeEngine, Temperature(T), keys=[5, 5],
                     traffic=traffic, one_prompt=True)
    assert same[0] == same[1]
    by_uid, _ = _serve(ServeEngine, Temperature(T), traffic=traffic,
                       one_prompt=True)
    assert by_uid[0] != by_uid[1]


@pytest.mark.parametrize("flag", [["--temperature", "0.7"],
                                  ["--top-k", "4", "--temperature", "0.9"]])
def test_launcher_samples(flag):
    args = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--paged",
            "--mixed", "--requests", "3", "--prompt-len", "12", "--gen", "6"]
    comps = launch_serve.main(args + flag)
    assert [len(c.tokens) for _, c in sorted(comps.items())] == [6, 3, 2]
    assert launch_serve.pick_sampler(launch_serve.parse_args(
        args + flag)) == (Temperature(0.7) if flag[0] == "--temperature"
                          else TopK(4, 0.9))
