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
