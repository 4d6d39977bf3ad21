"""The port's attention kernels, on the CPU: their plain versions and the
public wrappers against the JAX package's oracles and Pallas kernels (in
interpret mode, as the JAX tests run them), on the same numpy inputs.

The CUDA kernels themselves build and run only on a card; chip_smoke.py
holds them against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    # tests/test_kernels.py:17-19
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def make(seed, shapes, name="float32", scale=1.0):
    """numpy normals -> ([jax arrays], [torch tensors]) of dtype name."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[name]
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def close(t, j, **kw):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **kw)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------
FLASH_SWEEP = [                      # tests/test_kernels.py:26-31
    (1, 128, 4, 4, 64),              # MHA
    (2, 256, 8, 2, 64),              # GQA 4:1
    (1, 256, 8, 1, 32),              # MQA
    (1, 512, 2, 2, 128),             # full-size head dim
]


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D", FLASH_SWEEP)
def test_flash_plain_vs_ref(B, S, H, Hkv, D, name):
    (jq, jk, jv), (tq, tk, tv) = make(
        0, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], name)
    out = fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype
    close(out, jref.attention_ref(jq, jk, jv, causal=True), **tol(name))


@pytest.mark.parametrize("window", [64, 128])
def test_flash_plain_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = make(
        1, [(1, 256, 4, 32), (1, 256, 4, 32), (1, 256, 4, 32)])
    close(fa.flash_attention_plain(tq, tk, tv, window=window),
          jref.attention_ref(jq, jk, jv, causal=True, window=window),
          **tol("float32"))


def test_flash_plain_q_offset_is_top_left():
    """Rows at q_offset + i: with q_offset = Sk - S that is the oracle's
    bottom-right alignment."""
    (jq, jk, jv), (tq, tk, tv) = make(
        2, [(1, 64, 4, 32), (1, 192, 2, 32), (1, 192, 2, 32)])
    close(fa.flash_attention_plain(tq, tk, tv, q_offset=128),
          jref.attention_ref(jq, jk, jv, causal=True), **tol("float32"))


def test_flash_wrapper_vs_pallas_interpret():
    """ops.flash_attention on CPU tensors against the JAX package's Pallas
    kernel (interpret mode off-TPU), and the launch counter stays 0."""
    before = ops.flash_attention.launches
    (jq, jk, jv), (tq, tk, tv) = make(
        3, [(1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64)])
    out = ops.flash_attention(tq, tk, tv, True, 0)
    close(out, jops.flash_attention(jq, jk, jv, True, 0, 64, 64),
          **tol("float32"))
    assert ops.flash_attention.launches == before == 0


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_attention_ref_port(name):
    (jq, jk, jv), (tq, tk, tv) = make(
        4, [(2, 64, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16)], name)
    close(ref.attention_ref(tq, tk, tv, window=48),
          jref.attention_ref(jq, jk, jv, window=48), **tol(name))


@pytest.mark.parametrize("q_offset,window,S,Sk", [
    (0, 0, 128, 128), (0, 32, 128, 128), (64, 0, 64, 128)])
def test_chunked_attention_vs_jax(q_offset, window, S, Sk):
    (jq, jk, jv), (tq, tk, tv) = make(
        5, [(2, S, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16)])
    kw = dict(q_chunk=32, kv_chunk=32, q_offset=q_offset, window=window)
    close(tattn.chunked_attention(tq, tk, tv, **kw),
          jattn.chunked_attention(jq, jk, jv, **kw), rtol=1e-5, atol=1e-5)


def test_cuda_launchers_refuse_cpu_tensors():
    """The kernel launchers take CUDA tensors only: a CPU tensor is an
    error there, never a silent fallback."""
    _, (q, k, v) = make(6, [(1, 64, 2, 64), (1, 64, 2, 64), (1, 64, 2, 64)],
                        "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_cuda(q[:, 0], k, v, 10)


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------
DECODE_SWEEP = [                     # tests/test_decode_kernel.py:14-18
    (1, 4, 4, 64, 512),              # MHA
    (2, 8, 2, 64, 1024),             # GQA 4:1
    (1, 8, 1, 32, 512),              # MQA
    (2, 48, 4, 128, 544),            # G = 12 (starcoder2-15b's heads)
    (1, 32, 2, 64, 300),             # G = 16, one tile of q rows
    (1, 40, 2, 64, 300),             # G = 20: a second, partial tile
    (2, 48, 2, 128, 544),            # G = 24
    (1, 64, 2, 64, 512),             # G = 32: two whole tiles
]


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,Smax", DECODE_SWEEP)
def test_decode_plain_vs_jax(B, H, Hkv, D, Smax, name):
    (jq, jk, jv), (tq, tk, tv) = make(
        7, [(B, H, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D)], name, 0.5)
    for length in (1, Smax // 3, Smax):
        out = fd.flash_decode_plain(tq, tk, tv, length)
        assert out.dtype == tq.dtype
        close(out, jattn.decode_attention(jq, jk, jv, jnp.int32(length)),
              err_msg=f"len={length}", **tol(name))


def test_decode_plain_ignores_stale_cache():
    """Data at or beyond `length` (a reused buffer's previous request)
    must not leak into the output (tests/test_decode_kernel.py:34-48)."""
    (jq, jk, jv), (tq, tk, tv) = make(
        8, [(1, 2, 16), (1, 256, 2, 16), (1, 256, 2, 16)])
    kp, vp = tk.clone(), tv.clone()
    kp[:, 100:] = 1e9
    vp[:, 100:] = -1e9
    close(fd.flash_decode_plain(tq, kp, vp, 100),
          jattn.decode_attention(jq, jk, jv, jnp.int32(100)),
          rtol=2e-5, atol=2e-5)


def test_decode_wrapper_vs_pallas_interpret():
    before = ops.flash_decode.launches
    (jq, jk, jv), (tq, tk, tv) = make(
        9, [(2, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)], scale=0.5)
    for length in (1, 171, 512):
        close(ops.flash_decode(tq, tk, tv, length),
              jops.flash_decode(jq, jk, jv, jnp.int32(length), block_kv=256),
              err_msg=f"len={length}", **tol("float32"))
    assert ops.flash_decode.launches == before == 0


@pytest.mark.parametrize("H,Hkv,D", [(20, 1, 64), (48, 2, 128),
                                     (64, 2, 64)])
def test_decode_plain_past_one_tile_vs_pallas_interpret(H, Hkv, D):
    """G = 20, 24 and 32, past the kernel's 16 q rows a tile: the plain
    version (the wrapper on the CPU) against the Pallas decode kernel in
    interpret mode, which takes any G in one (1, 1, G, D) block; f32 at
    the JAX tests' tolerance, no launch."""
    (jq, jk, jv), (tq, tk, tv) = make(
        11, [(2, H, D), (2, 320, Hkv, D), (2, 320, Hkv, D)], scale=0.5)
    for length in (1, 107, 320):
        want = jops.flash_decode(jq, jk, jv, jnp.int32(length), block_kv=64)
        close(fd.flash_decode_plain(tq, tk, tv, length), want,
              err_msg=f"len={length}", **tol("float32"))
        close(ops.flash_decode(tq, tk, tv, length), want,
              err_msg=f"len={length}", **tol("float32"))
    assert ops.flash_decode.launches == 0


@pytest.mark.parametrize("H,Hkv,tiles", [(12, 2, 1), (32, 2, 1),
                                         (40, 2, 2), (64, 2, 2),
                                         (68, 2, 3), (8, 8, 1)])
def test_q_tiles_and_the_bound_read_kv_once(H, Hkv, tiles):
    """A kv head of G q heads is ceil(G / 16) cells; the byte bound
    reads the caches once whatever the tiles (a tile's re-read is the
    kernel's cost, not the function's)."""
    assert fd.q_tiles(H, Hkv) == tiles
    flops, nbytes = fd.work(4, H, Hkv, 64, 500)
    assert flops == 4.0 * 4 * H * 500 * 64
    assert nbytes == 2.0 * (2 * 4 * H * 64 + 2 * 4 * 500 * Hkv * 64)


def test_decode_attention_is_the_plain_version():
    assert tattn.decode_attention is fd.flash_decode_plain


@pytest.mark.parametrize("B,Hkv,length", [
    (4, 2, 1), (4, 2, 544), (4, 2, 4096), (1, 1, 100_000), (64, 8, 3),
    (4, 2, 528), (4, 2, 241), (4, 5, 1024), (4, 5, 47), (2, 2, 300)])
def test_plan_splits_cover_length(B, Hkv, length):
    """Splits are ranges of keys, none is empty, together they cover
    [0, length), one (batch, kv head) never needs more than one portable
    cluster, and the grid fills an H100's 132 SMs as far as the keys and
    the cluster cap allow: at most one block per SM, and twice the splits
    would pass 132 blocks, the cap or about ``MIN_KEYS`` keys a split."""
    n, per = fd.plan_splits(B, Hkv, length, 132)
    assert 1 <= n <= fd.MAX_SPLITS and per >= 1
    assert (n - 1) * per < length <= n * per
    assert n == 1 or B * Hkv * n <= 132
    assert (2 * n > min(fd.MAX_SPLITS, -(-length // fd.MIN_KEYS))
            or 2 * B * Hkv * n > 132)


@pytest.mark.parametrize("B,Hkv,tiles,length", [
    (4, 2, 1, 528), (4, 2, 2, 528), (4, 1, 2, 1000), (1, 2, 4, 5000),
    (4, 8, 2, 64)])
def test_plan_splits_count_every_tile(B, Hkv, tiles, length):
    """With q tiles the grid is B * Hkv * tiles cells of splits: within
    one block an SM as far as the keys allow, and one tile plans as
    before tiles."""
    n, per = fd.plan_splits(B, Hkv, length, 132, tiles)
    assert (n - 1) * per < length <= n * per
    assert n == 1 or B * Hkv * tiles * n <= 132
    assert (2 * n > min(fd.MAX_SPLITS, -(-length // fd.MIN_KEYS))
            or 2 * B * Hkv * tiles * n > 132)
    if tiles == 1:
        assert (n, per) == fd.plan_splits(B, Hkv, length, 132)


@pytest.mark.parametrize("B,Hkv,length,want", [
    (4, 2, 528, (8, 66)),      # qwen2 decode, mid-generation
    (4, 5, 1024, (4, 256))])   # hymba decode over the full ring
def test_plan_splits_at_serving_shapes(B, Hkv, length, want):
    """At both serving paths' decode shapes the planner takes the split
    count that ran fastest of 1-8 on an H100 in ``chip_smoke``'s split
    sweep: 8 splits of 66 keys at qwen2's (64 blocks) and 4 of 256 at
    hymba's (80 blocks, where 8 would be 160); the tile planner it
    replaced gave 9 splits of one 64-key tile at qwen2's."""
    assert fd.plan_splits(B, Hkv, length, 132) == want


def test_wrappers_refuse_grad_on_cuda_only():
    """requires_grad on CPU runs the differentiable plain version."""
    _, (q, k, v) = make(10, [(1, 64, 2, 16)] * 3)
    q.requires_grad_(True)
    ops.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and ops.flash_attention.launches == 0
