"""repro_torch layers, configs and the parameter bridge against the JAX
package, on the same numpy-made inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.models import layers as JL
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

RNG = np.random.default_rng(0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def both(a, name):
    """One numpy array as (jax array, torch tensor) of dtype ``name``."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a.copy()).to(td)


def close(t, j, **kw):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **kw)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_rms_norm(name):
    x = RNG.standard_normal((2, 5, 64)).astype(np.float32)
    w = RNG.standard_normal((64,)).astype(np.float32)
    (jx, tx), (jw, tw) = both(x, name), both(w, name)
    close(TL.rms_norm(tx, tw), JL.rms_norm(jx, jw), **tol(name))


@pytest.mark.parametrize("pos_shape", [(7,), (3, 1)])
def test_rope_freqs_and_apply(pos_shape):
    pos = RNG.integers(0, 600, pos_shape).astype(np.int32)
    jc, js = JL.rope_freqs(jnp.asarray(pos), 16, 1e6)
    tc, ts = TL.rope_freqs(torch.from_numpy(pos), 16, 1e6)
    close(tc, jc, rtol=1e-5, atol=1e-5)
    close(ts, js, rtol=1e-5, atol=1e-5)
    B, S = (3, 1) if len(pos_shape) == 2 else (2, 7)
    x = RNG.standard_normal((B, S, 4, 16)).astype(np.float32)
    close(TL.apply_rope(torch.from_numpy(x), tc, ts),
          JL.apply_rope(jnp.asarray(x), jc, js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_swiglu(name):
    x = RNG.standard_normal((2, 3, 32)).astype(np.float32)
    w1, w3 = (RNG.standard_normal((32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    w2 = RNG.standard_normal((48, 32)).astype(np.float32) * 0.2
    args = [both(a, name) for a in (x, w1, w3, w2)]
    close(TL.swiglu(*[t for _, t in args]), JL.swiglu(*[j for j, _ in args]),
          **tol(name))


@pytest.mark.parametrize("n,target", [(512, 256), (96, 64), (7, 4), (5, 8)])
def test_pick_chunk(n, target):
    assert TL.pick_chunk(n, target) == JL.pick_chunk(n, target)


@pytest.mark.parametrize("shape,scale", [((64, 128), 1.0), ((256, 64), 8.0)])
def test_dense_init_distribution(shape, scale):
    """Same truncated normal as the JAX init: +-2 sigma, std from the fan
    in of the unstacked shape, stacking dims excluded."""
    gen = torch.Generator()
    gen.manual_seed(0)
    w = TL.dense_init(gen, shape, torch.float32, scale, lead=(3,))
    j = np.asarray(JL.dense_init(jax.random.PRNGKey(0), (3,) + shape,
                                 jnp.float32, scale))
    assert tuple(w.shape) == (3,) + shape
    std = scale / shape[-2] ** 0.5
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # truncated at +-2: std is 0.8796 of the untruncated one
    np.testing.assert_allclose(float(w.std()), 0.8796 * std, rtol=3e-2)
    np.testing.assert_allclose(float(w.std()), float(j[0].std()), rtol=5e-2)


def test_dense_init_is_seeded():
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(5)
    b.manual_seed(5)
    assert torch.equal(TL.dense_init(a, (8, 8), torch.bfloat16),
                       TL.dense_init(b, (8, 8), torch.bfloat16))


@pytest.mark.parametrize("reduced", [False, True])
def test_qwen2_config_matches_jax(reduced):
    _config_matches_jax("qwen2-1.5b", reduced)


@pytest.mark.parametrize("reduced", [False, True])
def test_hymba_config_matches_jax(reduced):
    _config_matches_jax("hymba-1.5b", reduced)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "xlstm-125m"])
def test_moe_and_xlstm_configs_match_jax(name, reduced):
    _config_matches_jax(name, reduced)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", jax_list_configs())
def test_every_config_matches_jax(name, reduced):
    _config_matches_jax(name, reduced)


def _config_matches_jax(name, reduced):
    t, j = get_config(name), jax_get_config(name)
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.blocks == j.blocks and t.n_params() == j.n_params()
    # the JAX package's ten, and the port's own granite-4.0-h-small
    assert jax_list_configs() == (
        "granite-moe-1b-a400m", "hymba-1.5b", "llama4-maverick-400b-a17b",
        "llava-next-mistral-7b", "musicgen-large", "qwen2-1.5b", "qwen3-32b",
        "starcoder2-15b", "xlstm-125m", "yi-6b")
    assert list_configs() == tuple(sorted(jax_list_configs()
                                          + ("granite-4.0-h-small",)))


def test_params_from_jax_bf16_and_readonly():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {"w": a.astype(ml_dtypes.bfloat16), "n": {"b": a}}
    tree["n"]["b"].setflags(write=False)
    out = params_from_jax(tree, "cpu")
    assert out["w"].dtype == torch.bfloat16
    assert out["n"]["b"].dtype == torch.float32     # each leaf keeps its dtype
    np.testing.assert_array_equal(out["w"].float().numpy(), a)
    out["n"]["b"] += 1          # writable: the bridge copied
    np.testing.assert_array_equal(a, np.arange(12).reshape(3, 4))
