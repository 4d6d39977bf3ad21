"""How far rounding alone moves the reduced xlstm-125m's logits, with the
seeded weights as they are and with the mLSTM's wq, wk and wif tempered:
why the port's xLSTM tests temper them (``tests/test_torch_xlstm.py``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/xlstm_conditioning.py

For each temper factor it prints the max abs error over the largest
logit of the prefill (2 x 48 tokens, mLSTM chunks of 16) between the JAX
package in bf16 and in f32 on the same bf16-valued weights, the port in
bf16 against JAX in f32, and, after 4 teacher-forced decode steps, the
port in f32 against JAX in f32.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _grow_cache as jax_grow
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as T

NAME, S, STEPS = "xlstm-125m", 48, 4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def tempered(tree, factor):
    for e in tree["layers"].values():
        for w in ("wq", "wk", "wif") if "mlstm" in e else ():
            e["mlstm"][w] = (e["mlstm"][w].astype(np.float32) * factor
                             ).astype(e["mlstm"][w].dtype)
    return tree


def configs(dtype):
    return (dataclasses.replace(get_config(NAME).reduced(), dtype=dtype),
            dataclasses.replace(jax_get_config(NAME).reduced(), dtype=dtype))


def main() -> None:
    kw = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16)
    jopts, topts = JT.ModelOptions(**kw), T.ModelOptions(**kw)
    toks = np.random.default_rng(1).integers(0, 256, (2, S), np.int32)
    forced = np.random.default_rng(3).integers(0, 256, (STEPS, 2))
    for factor in (1.0, 0.125):
        tcfg16, jcfg16 = configs("bfloat16")
        tcfg32, jcfg32 = configs("float32")
        tree16 = tempered(jax.tree.map(np.asarray, JT.init_params(
            jax.random.PRNGKey(0), jcfg16)), factor)
        tree32 = jax.tree.map(lambda a: a.astype(np.float32), tree16)
        j16, _ = JT.prefill(jax.tree.map(jnp.asarray, tree16), jcfg16,
                            jnp.asarray(toks), opts=jopts)
        j32, jc = JT.prefill(jax.tree.map(jnp.asarray, tree32), jcfg32,
                             jnp.asarray(toks), opts=jopts)
        t16, _ = T.prefill(params_from_jax(tree16, "cpu"), tcfg16,
                           torch.from_numpy(toks).long(), opts=topts)
        tp32 = params_from_jax(tree32, "cpu")
        t32, tc = T.prefill(tp32, tcfg32, torch.from_numpy(toks).long(),
                            opts=topts)
        jc = jax_grow(jcfg32, jc, 2, S + STEPS, S)
        tc = serve_mod._grow_cache(tc, S + STEPS, S)
        jp32 = jax.tree.map(jnp.asarray, tree32)
        for t in range(STEPS):
            j32d, jc = JT.decode_step(
                jp32, jcfg32, jc, token=jnp.asarray(forced[t], jnp.int32),
                pos=jnp.int32(S + t), opts=jopts)
            t32d, tc = T.decode_step(tp32, tcfg32, tc, token=torch.from_numpy(
                forced[t]).long(), pos=S + t, opts=topts)
        print(f"temper {factor}: prefill JAX bf16 vs JAX f32 "
              f"{rel(j16, j32):.4g}, port bf16 vs JAX f32 "
              f"{rel(t16.float().numpy(), j32):.4g}; after {STEPS} decode "
              f"steps port f32 vs JAX f32 {rel(t32d.numpy(), j32d):.3g}",
              flush=True)


if __name__ == "__main__":
    main()
