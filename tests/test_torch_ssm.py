"""The port's SSD scan and mamba mixer, on the CPU: the scan's plain
version and public wrapper against the JAX package's oracle and Pallas
kernel (in interpret mode, as the JAX tests run it), and the mixer against
the JAX mixer, on the same numpy inputs.

The CUDA kernel itself builds and runs only on a card; chip_smoke.py
holds it against this plain version there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import ssm as tssm

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SSM_SWEEP = [                        # tests/test_kernels.py:93-97
    (1, 128, 2, 16, 16, 64),
    (2, 256, 4, 32, 16, 128),
    (1, 256, 1, 64, 32, 256),        # single head, chunk == S
]


def y_tol(name):
    # tests/test_kernels.py:17-19
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def h_tol(name):
    # tests/test_kernels.py:109-111
    t = 1e-2 if name == "bfloat16" else 1e-4
    return dict(rtol=t, atol=t)


def scan_inputs(seed, B, S, nh, hd, st, name="float32", decay=None):
    """numpy draws shaped as tests/test_kernels.py's: xv N*0.5, logdecay
    -softplus(N) (or the constant ``decay``), B/C N*0.3, h0 N*0.1.
    Returns ({jax arrays}, {torch tensors}); logdecay and h0 stay fp32."""
    rng = np.random.default_rng(seed)
    a = {"xv": rng.standard_normal((B, S, nh, hd)) * 0.5,
         "ld": -np.logaddexp(0.0, rng.standard_normal((B, S, nh))),
         "Bm": rng.standard_normal((B, S, st)) * 0.3,
         "Cm": rng.standard_normal((B, S, st)) * 0.3,
         "h0": rng.standard_normal((B, nh, hd, st)) * 0.1}
    if decay is not None:
        a["ld"] = np.full((B, S, nh), decay)
    a = {k: v.astype(np.float32) for k, v in a.items()}
    jd, td = DTYPES[name]
    low = ("xv", "Bm", "Cm")
    return ({k: jnp.asarray(v, jd if k in low else jnp.float32)
             for k, v in a.items()},
            {k: torch.from_numpy(v).to(td if k in low else torch.float32)
             for k, v in a.items()})


def close(t, j, **kw):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **kw)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,nh,hd,st,chunk", SSM_SWEEP)
def test_ssm_plain_vs_ref(B, S, nh, hd, st, chunk, name, with_h0):
    j, t = scan_inputs(0, B, S, nh, hd, st, name)
    jh0, th0 = (j["h0"], t["h0"]) if with_h0 else (None, None)
    y, h = ss.ssm_scan_plain(t["xv"], t["ld"], t["Bm"], t["Cm"], th0,
                             chunk=chunk)
    yr, hr = jref.ssm_scan_ref(j["xv"], j["ld"], j["Bm"], j["Cm"], jh0)
    assert y.dtype == t["xv"].dtype and h.dtype == torch.float32
    close(y, yr, **y_tol(name))
    close(h, hr, **h_tol(name))


def test_ssm_wrapper_vs_pallas_interpret():
    """ops.ssm_scan on CPU tensors against the JAX package's Pallas
    kernel (interpret mode off-TPU); the launch counter stays 0."""
    ops.ssm_scan.launches = 0
    j, t = scan_inputs(1, 2, 128, 2, 16, 16)
    y, h = ops.ssm_scan(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"], 64)
    yj, hj = jops.ssm_scan(j["xv"], j["ld"], j["Bm"], j["Cm"], j["h0"], 64)
    close(y, yj, **y_tol("float32"))
    close(h, hj, **h_tol("float32"))
    assert ops.ssm_scan.launches == 0


def test_ssm_plain_ragged_length():
    """S = 200 with chunk 64: the plain version takes the largest divisor
    of S below the chunk (50), as ssd_chunked does."""
    j, t = scan_inputs(2, 1, 200, 3, 16, 16)
    y, h = ss.ssm_scan_plain(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"],
                             chunk=64)
    yr, hr = jref.ssm_scan_ref(j["xv"], j["ld"], j["Bm"], j["Cm"], j["h0"])
    close(y, yr, **y_tol("float32"))
    close(h, hr, **h_tol("float32"))


def test_ssm_plain_strong_decay_is_finite():
    """logdecay = -20 per step: exp of the upper triangle's deltas would
    overflow to inf, and inf * 0 is NaN; masked before exp it is 0."""
    j, t = scan_inputs(3, 1, 128, 2, 16, 16, decay=-20.0)
    y, h = ss.ssm_scan_plain(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"],
                             chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    yr, hr = jref.ssm_scan_ref(j["xv"], j["ld"], j["Bm"], j["Cm"], j["h0"])
    close(y, yr, **y_tol("float32"))
    close(h, hr, **h_tol("float32"))


@pytest.mark.parametrize("with_h0", [True, False])
def test_ssm_scan_ref_port(with_h0):
    j, t = scan_inputs(4, 2, 64, 2, 8, 8)
    jh0, th0 = (j["h0"], t["h0"]) if with_h0 else (None, None)
    y, h = ref.ssm_scan_ref(t["xv"], t["ld"], t["Bm"], t["Cm"], th0)
    yr, hr = jref.ssm_scan_ref(j["xv"], j["ld"], j["Bm"], j["Cm"], jh0)
    close(y, yr, rtol=1e-5, atol=1e-5)
    close(h, hr, rtol=1e-5, atol=1e-5)


def test_ssm_cuda_launcher_refuses_cpu_tensors():
    _, t = scan_inputs(5, 1, 64, 2, 16, 16, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_cuda(t["xv"], t["ld"], t["Bm"], t["Cm"])


def test_ssm_wrapper_grad_on_cpu():
    """requires_grad on CPU runs the differentiable plain version."""
    ops.ssm_scan.launches = 0
    _, t = scan_inputs(6, 1, 64, 2, 8, 8)
    xv = t["xv"].requires_grad_(True)
    y, h = ops.ssm_scan(xv, t["ld"], t["Bm"], t["Cm"], None, 32)
    (y.sum() + h.sum()).backward()
    assert xv.grad is not None and ops.ssm_scan.launches == 0


def mixer_params(d, nh, hd, st):
    jp = jssm.init_ssm_params(jax.random.PRNGKey(7), d, nh, hd, st,
                              jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_mamba_forward_prefill_and_decode_vs_jax():
    """Prefill (chunked scan) and then two recurrent decode steps that
    carry the ssm state and the conv window, f32 at 1e-4."""
    d, nh, hd, st = 32, 2, 8, 8
    jp, tp = mixer_params(d, nh, hd, st)
    x = (np.random.default_rng(8).standard_normal((2, 67, d)) * 0.5
         ).astype(np.float32)
    kw = dict(n_heads=nh, head_dim=hd, state=st)
    jy, (jh, jc) = jssm.mamba_forward(jp, jnp.asarray(x[:, :64]), chunk=16,
                                      **kw)
    ty, (th, tc) = tssm.mamba_forward(tp, torch.from_numpy(x[:, :64]),
                                      chunk=16, **kw)
    tol = dict(rtol=1e-4, atol=1e-4)
    close(ty, jy, **tol)
    close(th, jh, **tol)
    close(tc, jc, **tol)
    for t in range(64, 67):
        jy, (jh, jc) = jssm.mamba_forward(
            jp, jnp.asarray(x[:, t:t + 1]), ssm_state=jh, conv_state=jc,
            **kw)
        ty, (th, tc) = tssm.mamba_forward(
            tp, torch.from_numpy(x[:, t:t + 1]), ssm_state=th,
            conv_state=tc, **kw)
        close(ty, jy, err_msg=f"step {t}", **tol)
        close(th, jh, err_msg=f"step {t}", **tol)
        close(tc, jc, err_msg=f"step {t}", **tol)


def test_ssm_params_keep_fp32_leaves():
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tssm.init_ssm_params(gen, 32, 2, 8, 8, torch.bfloat16, lead=(3,))
    jp = jssm.init_ssm_params(jax.random.PRNGKey(0), 32, 2, 8, 8,
                              jnp.bfloat16)
    assert p.keys() == jp.keys()
    for k, v in p.items():
        assert tuple(v.shape) == (3,) + jp[k].shape, k
        assert str(v.dtype).split(".")[-1] == jp[k].dtype.name, k


# ---- the Hopper kernel's arithmetic, emulated on the CPU ----------------

def _bf16(t):
    """Round fp32 values to bf16 and back: an mma.sync operand."""
    return t.to(torch.bfloat16).float()


def _bf16_split(t):
    """fp32 values as the sum of two bf16 operands, hi + lo."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def emulate_kernel(xv, ld, Bm, Cm, h0=None, chunk=64, state=_bf16_split):
    """csrc/ssm_scan.cu's three steps in plain fp32 torch, each operand
    rounded exactly where the kernel rounds it: B * w to bf16 (step 1),
    G = L * C B^T to bf16 and the entering state to bf16 hi + lo (step 3;
    ``state`` replaces that rounding).  Chunks of min(chunk, S) with the
    ragged tail zero-filled and logdecay 0 there, as the kernel cuts them.
    Returns (y bf16, h_final fp32)."""
    B, S, nh, hd = xv.shape
    st = Bm.shape[-1]
    c = min(chunk, S)
    n = -(-S // c)
    pad = n * c - S
    x = torch.nn.functional.pad(xv.float(), (0, 0, 0, 0, 0, pad))
    x = x.reshape(B, n, c, nh, hd)
    lc = torch.nn.functional.pad(ld.float(), (0, 0, 0, pad))
    Bc = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cc = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    Bc, Cc = Bc.reshape(B, n, c, st), Cc.reshape(B, n, c, st)
    cum = torch.cumsum(lc.reshape(B, n, c, nh), dim=2)
    total = cum[:, :, -1]                                  # (B,n,nh)
    # step 1: S_i = X^T bf16(B * exp(total - cum))
    w = torch.exp(total[:, :, None] - cum)                 # (B,n,c,nh)
    bw = _bf16(Bc[:, :, :, None, :] * w[..., None])        # (B,n,c,nh,st)
    s_i = torch.einsum("bnchd,bnchs->bnhds", x, bw)
    # step 2: fp32 recurrence; the state entering each chunk
    h = torch.zeros((B, nh, hd, st)) if h0 is None else h0.float()
    enter = []
    for i in range(n):
        enter.append(h)
        h = torch.exp(total[:, i])[:, :, None, None] * h + s_i[:, i]
    # step 3: y = bf16(L * C B^T) X + exp(cum) * (C state(h)^T)
    cb = torch.einsum("bncs,bnks->bnck", Cc, Bc)           # exact
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,n,t,tau,nh)
    tri = torch.ones((c, c), dtype=torch.bool).tril()[:, :, None]
    g = torch.where(tri, torch.exp(torch.where(tri, dec, 0.0)), 0.0)
    g = _bf16(g * cb[..., None])
    y = torch.einsum("bntkh,bnkhd->bnthd", g, x)
    hin = state(torch.stack(enter, 1))                     # (B,n,nh,hd,st)
    y = y + torch.einsum("bncs,bnhds->bnchd", Cc, hin) \
        * torch.exp(cum)[..., None]
    y = y.reshape(B, n * c, nh, hd)[:, :S]
    return y.to(torch.bfloat16), h


def row_ratio(t, j):
    """Largest per-row max abs error over that row's largest |reference|,
    the on-card check's second test (chip_smoke.ROW_TOL)."""
    want = torch.from_numpy(np.asarray(j, np.float32))
    err = (t.float() - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


# (B, S, nh, chunk, decay): several chunks of the serving shape's hd 64,
# st 16, chunk 64; a ragged S; a strong decay
KERNEL_CASES = [(1, 256, 3, 64, None), (2, 200, 2, 64, None),
                (1, 256, 2, 64, -20.0), (1, 100, 2, 256, None)]


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,nh,chunk,decay", KERNEL_CASES)
def test_ssm_kernel_rounding_holds_tolerance(B, S, nh, chunk, decay,
                                             with_h0):
    """The kernel's bf16 operands (emulated) against the JAX package's
    sequential oracle, at the JAX kernel tests' unchanged bf16 tolerances:
    y at rtol = atol = 2e-2 and each row within 2e-2 of its largest
    value, h_final at 1e-2."""
    j, t = scan_inputs(10 + S, B, S, nh, 64, 16, "bfloat16", decay)
    jh0, th0 = (j["h0"], t["h0"]) if with_h0 else (None, None)
    y, h = emulate_kernel(t["xv"], t["ld"], t["Bm"], t["Cm"], th0, chunk)
    yr, hr = jref.ssm_scan_ref(j["xv"], j["ld"], j["Bm"], j["Cm"], jh0)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    close(y, yr, **y_tol("bfloat16"))
    assert row_ratio(y, yr) <= 2e-2
    close(h, hr, **h_tol("bfloat16"))


def test_ssm_kernel_state_needs_the_split():
    """Why the kernel splits the entering state into bf16 hi + lo: on a
    serving-length prompt (24 chunks of 64, 25 heads) rounding it to bf16
    alone puts a row's error above 2e-2 of its largest value; the split
    holds it at the rounding of y itself."""
    _, t = scan_inputs(101, 2, 1536, 25, 64, 16, "bfloat16")
    yp, _ = ss.ssm_scan_plain(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"],
                              chunk=64)
    want = yp.float().numpy()
    y, _ = emulate_kernel(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"], 64)
    assert row_ratio(y, want) <= 1e-2
    y, _ = emulate_kernel(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"], 64,
                          state=_bf16)
    assert row_ratio(y, want) > 2e-2


def test_ssm_kernel_emulation_rounds():
    """The emulation does round: against the plain fp32 version on the
    same inputs it differs, and by no more than bf16 operands explain."""
    _, t = scan_inputs(20, 1, 128, 2, 64, 16, "bfloat16")
    y, h = emulate_kernel(t["xv"], t["ld"], t["Bm"], t["Cm"], t["h0"], 64)
    yp, hp = ss.ssm_scan_plain(t["xv"].float(), t["ld"], t["Bm"].float(),
                               t["Cm"].float(), t["h0"], chunk=64)
    assert not torch.equal(h, hp)
    scale = float(hp.abs().max())
    assert 0 < float((h - hp).abs().max()) <= 2 ** -8 * scale
    assert float((y.float() - yp).abs().max()) <= 2 ** -6 * float(
        yp.abs().max())


# ---- the launch plan the C launcher mirrors ------------------------------

SERVING = (4, 1536, 25, 64, 16, 64)     # chip_smoke.PATHS, serve's chunk
MAX_HD = ss.MAX_HEAD_DIM


@pytest.mark.parametrize("nh", [1, 3, 7, 25])
@pytest.mark.parametrize("S,chunk,n_chunks", [
    (300, 64, 5),       # 4 x 64 + a ragged 44
    (1536, 64, 24),     # the serving prompt
    (1576, 64, 25),     # 24 x 64 + a ragged 40
    (50, 64, 1),        # S below the chunk: one chunk of S
    (7, 1, 7),          # chunks of one position
    (200, 256, 1)])
def test_ssm_plan_covers_every_head_once(nh, S, chunk, n_chunks):
    p = ss.plan(2, S, nh, 64, 16, chunk)
    k = p.heads_per_block
    assert k == min(ss.HEADS_PER_BLOCK, nh)
    # the kernels' cut: group g holds heads [g k, min(g k + k, nh))
    groups = [range(g * k, min(g * k + k, nh)) for g in range(p.n_groups)]
    assert [h for grp in groups for h in grp] == list(range(nh))
    assert all(len(grp) >= 1 for grp in groups)
    # and chunk i holds positions [i c, min(i c + c, S))
    assert p.chunk == min(chunk, S) and p.n_chunks == n_chunks
    assert (p.n_chunks - 1) * p.chunk < S <= p.n_chunks * p.chunk
    assert p.blocks == 2 * p.n_chunks * p.n_groups


def test_ssm_plan_serving_shape():
    p = ss.plan(*SERVING)
    assert (p.chunk, p.n_chunks) == (64, 24)
    assert p.heads_per_block == ss.HEADS_PER_BLOCK
    assert p.n_groups * p.heads_per_block >= 25
    assert p.blocks == 4 * 24 * p.n_groups
    assert p.workspace == (4, 24, 25, 64, 16)
    assert p.decay == (4, 24, 25)
    assert p.pass_blocks * ss.PASS_THREADS >= 4 * 25 * 64 * 16
    # 9.8 MB of fp32 chunk states
    assert int(np.prod(p.workspace)) * 4 == 9_830_400


@pytest.mark.parametrize("B,S,nh,hd,st,chunk",
                         SSM_SWEEP + [SERVING, (1, 256, 1, 128, 32, 256),
                                      (2, 4096, 8, 128, 32, 256)])
def test_ssm_plan_shared_memory_fits(B, S, nh, hd, st, chunk):
    p = ss.plan(B, S, nh, hd, st, chunk)
    assert 0 < p.smem_state <= ss.MAX_SMEM
    assert 0 < p.smem_out <= ss.MAX_SMEM
    assert p.smem_out == ss.smem_bytes(p.chunk, hd, st, p.heads_per_block, 3)
    assert p.smem_state == ss.smem_bytes(p.chunk, hd, st,
                                         p.heads_per_block, 1)
    # X rows are 16-byte aligned for cp.async, padded where that fits
    for ldx in (p.ldx_state, p.ldx_out):
        assert ldx % 8 == 0 and ldx - (-(-hd // 16) * 16) in (0, 8)


def test_ssm_plan_shrinks_the_group_to_fit():
    """At the largest shapes the group of heads shrinks until shared
    memory holds it; where one head does not fit at the chunk asked for,
    the chunk is halved until it does (a shape that raised before state
    128 was taken), and two heads are tried again at that chunk."""
    p = ss.plan(1, 256, 8, 128, 32, 256)
    assert p.heads_per_block < ss.HEADS_PER_BLOCK
    assert ss.smem_bytes(256, 128, 32, p.heads_per_block + 1, 3) \
        > ss.MAX_SMEM
    assert ss.plan(1, 128, 8, 128, 32, 128).heads_per_block \
        == ss.HEADS_PER_BLOCK
    p = ss.plan(1, 256, 1, 128, 64, 256)
    assert (p.chunk, p.heads_per_block) == (128, 1)
    assert ss.smem_bytes(256, 128, 64, 1, 3) > ss.MAX_SMEM
    assert max(p.smem_state, p.smem_out) <= ss.MAX_SMEM


def test_ssm_plan_takes_every_shape_the_one_block_kernel_took():
    """The kernel this one replaced kept a chunk's X, B, C, cum, w and the
    state in fp32 shared memory, 4 (c hd + 2 c (st + 1) + 2 c + st hd)
    bytes; every shape that fitted there fits one head per block here."""
    for c in (1, 15, 16, 63, 64, 100, 128, 200, 256):
        for hd in range(8, MAX_HD + 1, 8):
            for st in range(1, ss.MAX_STATE + 1):
                if 4 * (c * hd + 2 * c * (st + 1) + 2 * c + st * hd) \
                        > ss.MAX_SMEM:
                    continue
                p = ss.plan(1, c, 1, hd, st, c)
                assert p.heads_per_block == 1, (c, hd, st)


@pytest.mark.parametrize("bad", [dict(hd=12), dict(hd=136), dict(st=129),
                                 dict(chunk=0), dict(chunk=257),
                                 dict(st=0)])
def test_ssm_plan_refuses_what_the_kernel_does_not_take(bad):
    kw = dict(hd=64, st=16, chunk=64)
    kw.update(bad)
    with pytest.raises(ValueError):
        ss.plan(1, 128, 4, kw["hd"], kw["st"], kw["chunk"])
