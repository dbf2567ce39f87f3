"""The arithmetic of the split paged-attention kernel, pinned on the CPU.

``csrc/paged_attn.cu`` cuts each slot's table into slices of whole
tiles (``ops.split_plan``, from shapes only), runs an f32 online softmax
over the tiles of its slice that lie between the window's left edge and
the last query (each tile's keys split between two groups of warps,
each with its own online softmax, merged at the slice's end), leaves
an unnormalised partial (m, l, acc) per slice (empty where nothing is
visible: l = 0), and merges the partials in slice order, each rescaled
by exp(m_i - m), rounding once at the end.
Quantized rows are widened and multiplied by their scale before the
scores, as the reference dequantizes them.  This file emulates that
arithmetic in plain torch, with the kernel's tile and slice boundaries
on an H100's 132 SMs, and holds it to the reference's interpreted
Pallas kernel (``paged_attention_bhgd``, f32 inside, one rounding) under
the rule ``chip_smoke.py`` holds the kernel to: each element within two
ulps of its own value + 1e-4 in bf16, 1e-4 in f32.  On the same inputs a
merge without the rescale, and a merge that drops one slice's partial,
break that rule, so the rule sees both terms.

Inputs are made with numpy from a seed: pools of N(0, 1) rows (rounded
to bf16 for bf16 pools), or of N(0, 1) rows times 2^u, u uniform in
[-8, 0] per (position, kv head), quantized to int8 or fp8 by the
reference (scales spanning 2^8); q ~ N(0, 4), so the slices' maxima
differ.  Table entries past a slot's blocks point at block 0 (the
engine's trash block), which holds rows like any other.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import ops as jpa
from repro.models import quant as jq
from repro_torch.kernels.paged_attn import ops as pa
from test_torch_kernels_gpu import bf16_err_over_limit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one thread a test process, so that parallel test workers do not
    # oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NEG_INF = -1.0e30
N_SM = 132          # an H100 SXM's SMs: the split the card would run
KEY_GROUPS = 2      # csrc: KG, groups of warps that split a tile's keys
F32_TOL = 1e-4

CASES = {
    # name: (ctx per slot, C, H, KH, D, block_len, nbt or None, window,
    #        softcap).  nbt None: the longest slot's blocks.
    # a window that leaves the leftmost slices of the long slots empty
    "window": ([700, 300, 1000], 1, 8, 2, 64, 16, None, 150, 0.0),
    # slot 0 ends inside its first slice
    "short_slot": ([5, 600, 257], 1, 8, 2, 64, 16, None, 0, 0.0),
    # a table four times the longest context: the tail slices cover only
    # trash entries
    "trash_tail": ([40, 200, 90], 1, 8, 2, 64, 16, 50, 0, 30.0),
    # C = 4: the chunks of slots 0 and 1 straddle a slice boundary
    "chunk_c4": ([66, 130, 300], 4, 8, 2, 64, 8, None, 0, 0.0),
    "d24": ([33, 400, 150], 2, 6, 3, 24, 16, None, 100, 30.0),
    "d256": ([300, 77], 2, 4, 2, 256, 16, None, 0, 0.0),
    # the serve path's shape: 8 slots, 2 tiles a slice
    "serve": ([int(c) for c in np.linspace(64, 1088, 8)], 1, 32, 4, 64,
              16, None, 0, 0.0),
}
POOLS = ("f32", "bf16", "int8", "fp8")
# every case with every pool, the serve shape with bf16 and int8 pools
PARAMS = [(n, p) for n in sorted(CASES) if n != "serve" for p in POOLS] + [
    ("serve", "bf16"), ("serve", "int8")]


def _inputs(ctx, C, H, KH, D, bl, nbt, pool, seed):
    """q, the pools as float32 values of their storage (codes for int8 and
    fp8), their scales (None unquantized), the table and pos."""
    rng = np.random.default_rng(seed)
    B = len(ctx)
    nbt = nbt or -(-max(ctx) // bl)
    need = [-(-c // bl) for c in ctx]
    n_blocks = 1 + sum(need)
    perm = rng.permutation(n_blocks - 1) + 1
    bt = np.zeros((B, nbt), np.int32)
    o = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[o:o + n]
        o += n
    pos = np.array([c - C for c in ctx], np.int32)
    q = (2 * rng.normal(size=(B, C, H, D))).astype(np.float32)
    shape = (n_blocks, bl, KH, D)
    if pool in ("f32", "bf16"):
        kv = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
        if pool == "bf16":
            q, *kv = (np.array(jnp.asarray(x, jnp.bfloat16)
                                 .astype(jnp.float32)) for x in (q, *kv))
        return q, kv[0], kv[1], None, None, bt, pos
    out = []
    for _ in range(2):
        u = rng.uniform(-8, 0, size=shape[:3] + (1,))
        x = (rng.normal(size=shape) * 2.0 ** u).astype(np.float32)
        code, s = jq.quantize(jnp.asarray(x), pool)
        out += [np.array(code.astype(jnp.float32)), np.array(s)]
    return q, out[0], out[2], out[1], out[3], bt, pos


def _reference(q, kp, vp, ks, vs, bt, pos, pool, out_dtype, **kw):
    """The reference's Pallas kernel, interpreted, on the same inputs."""
    store = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
             "fp8": jnp.float8_e4m3fn}[pool]
    act = jnp.bfloat16 if pool == "bf16" else jnp.float32
    args = (jnp.asarray(q, act), jnp.asarray(kp).astype(store),
            jnp.asarray(vp).astype(store), jnp.asarray(bt), jnp.asarray(pos))
    if ks is not None:
        kw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = jpa.paged_decode_attention(*args, interpret=True,
                                     out_dtype=out_dtype, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _online(qr, kg, vg, ranges, qpos, *, window, softcap, scale):
    """One online softmax over the key ranges in order: (m, l, acc)."""
    R, D = qr.shape
    m = torch.full((R,), NEG_INF)
    l = torch.zeros(R)
    acc = torch.zeros(R, D)
    for a, e in ranges:
        kpos = torch.arange(a, e)
        s = (qr @ kg[a:e].T) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = kpos[None] <= qpos[:, None]
        if window > 0:
            ok = ok & (kpos[None] > qpos[:, None] - window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[:, None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[:, None] + p @ vg[a:e]
        m = m_new
    return m, l, acc


def _merge(states, fault=None):
    """States over disjoint keys, merged in order, each weighted by
    exp(m_i - m) (m the largest max of a state with l > 0; a state with
    l = 0 weighs 0).  ``fault`` "no_rescale" weighs every state 1."""
    mx = torch.full_like(states[0][0], NEG_INF)
    for m, l, _ in states:
        mx = torch.where(l > 0, torch.maximum(mx, m), mx)
    den = torch.zeros_like(mx)
    num = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.where(l > 0, torch.exp(m - mx), torch.zeros_like(l))
        if fault == "no_rescale":
            w = (l > 0).float()
        den = den + w * l
        num = num + w[:, None] * acc
    return mx, den, num


def emulate(q, kp, vp, ks, vs, bt, pos, *, window, softcap, elem_size,
            fault=None):
    """The kernel's arithmetic in f32 -> (B, C, H, D) float32, before the
    one rounding to the output dtype.  A slice's tiles are split between
    KEY_GROUPS groups of warps, each with its own online softmax, merged
    at the slice's end; the slices then merge in order.  ``fault``:
    "no_rescale" merges the slices unscaled, "drop" drops each (slot, kv
    head)'s first slice that holds a visible key."""
    q, kp, vp, bt = (torch.from_numpy(x) for x in (q, kp, vp, bt))
    B, C, H, D = q.shape
    bl, KH = kp.shape[1], kp.shape[2]
    G, nbt = H // KH, bt.shape[1]
    if ks is not None:          # widened, then scaled, element by element
        kp = kp * torch.from_numpy(ks)[..., None]
        vp = vp * torch.from_numpy(vs)[..., None]
    L = nbt * bl
    tk = pa.tile_keys(D, elem_size)
    wk = tk // KEY_GROUPS
    tps, n_split = pa.split_plan(B, C, H, KH, D, elem_size, bl, nbt, N_SM)
    kw = dict(window=window, softcap=softcap,
              scale=torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32))
    out = torch.zeros(B, C, H, D)
    for b in range(B):
        p0 = int(pos[b])
        k_hi = min(p0 + C, L)
        k_lo = max(0, p0 - window + 1) if window > 0 else 0
        rows = bt[b].long()
        kg = kp[rows].reshape(L, KH, D)
        vg = vp[rows].reshape(L, KH, D)
        qpos = p0 + torch.arange(C * G) // G
        for kh in range(KH):
            qr = q[b, :, kh * G:(kh + 1) * G].reshape(C * G, D)
            slices = []
            for i in range(n_split):
                lo = max(i * tps * tk, k_lo)
                hi = min((i + 1) * tps * tk, L, k_hi)
                tiles = range(lo // tk, -(-hi // tk) if lo < hi else 0)
                groups = [[(max(t * tk + g * wk, lo),
                            min(t * tk + (g + 1) * wk, hi)) for t in tiles]
                          for g in range(KEY_GROUPS)]
                slices.append(_merge([
                    _online(qr, kg[:, kh], vg[:, kh],
                            [(a, e) for a, e in rg if a < e], qpos, **kw)
                    for rg in groups]))
            if fault == "drop":
                i = next(i for i, (_, l, _) in enumerate(slices)
                         if (l > 0).any())
                slices[i] = (slices[i][0], torch.zeros(C * G),
                             torch.zeros(C * G, D))
            _, den, num = _merge(slices, fault)
            o = num / den.clamp_min(1e-30)[:, None]
            out[b, :, kh * G:(kh + 1) * G] = o.reshape(C, G, D)
    return out


def err_over_limit(got, want, out_dtype):
    """``chip_smoke.py::check_close``'s rule: two ulps + 1e-4 in bf16,
    1e-4 in f32."""
    if out_dtype == jnp.bfloat16:
        return bf16_err_over_limit(got.to(torch.bfloat16), want)
    return ((got - want).abs() / F32_TOL).max().item()


@pytest.mark.parametrize("name,pool", PARAMS)
def test_split_merge_keeps_the_rule_and_faults_break_it(name, pool):
    ctx, C, H, KH, D, bl, nbt, window, softcap = CASES[name]
    q, kp, vp, ks, vs, bt, pos = _inputs(ctx, C, H, KH, D, bl, nbt, pool,
                                         seed=len(name) + D)
    elem = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}[pool]
    tps, n_split = pa.split_plan(len(ctx), C, H, KH, D, elem, bl,
                                 bt.shape[1], N_SM)
    assert n_split > 1, "the case must split its context"
    out_dtype = jnp.bfloat16 if pool in ("bf16", "int8") else jnp.float32
    kw = dict(window=window, softcap=softcap)
    want = _reference(q, kp, vp, ks, vs, bt, pos, pool, out_dtype, **kw)
    run = dict(elem_size=elem, **kw)
    ok = err_over_limit(emulate(q, kp, vp, ks, vs, bt, pos, **run), want,
                        out_dtype)
    assert ok <= 1.0, f"split and merge: {ok:.3g}x the limit"
    for fault in ("no_rescale", "drop"):
        bad = err_over_limit(emulate(q, kp, vp, ks, vs, bt, pos, fault=fault,
                                     **run), want, out_dtype)
        assert bad > 1.0, f"{fault}: only {bad:.3g}x the limit"
