"""What each rank of the port's multi-rank tests computes (see
``torch_ranks.py``; the tests compare it with the JAX package's results).
Rank 0 writes its results as ``.npz`` files into the directory it is
given; every rank checks what holds per rank itself (an assert fails the
rank, and the test with it)."""
import dataclasses
import functools
import os

import numpy as np
import torch

import torch_ranks
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as S
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.shardmap_compat import P
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_paths, tree_map

CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)


def _np_tree(npz, prefix):
    """A nested dict of arrays from the flat ``prefix/a/b`` keys of an
    npz."""
    out = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = npz[key]
    return out


def _flat(tree, prefix):
    return {f"{prefix}/" + "/".join(path): np.asarray(t)
            for path, t in leaves_with_paths(tree)}


def _full(tree, mesh):
    return tree_map(lambda t: smc.gather_full(t, mesh).float().numpy()
                    if t.is_floating_point() else
                    smc.gather_full(t, mesh).numpy(), tree)


# ---------------------------------------------------------------------------
# test_torch_mesh
# ---------------------------------------------------------------------------
def _moe_on(mesh, mode, ins, cf):
    """``moe_ffn``'s mesh path as the sharded steps run it: on each rank's
    blocks inside ``shard_map``, the weights in the reference's layout."""
    x, wr, w1, w3, w2 = (torch.from_numpy(ins[k]) for k in
                         ("x", "wr", "w1", "w3", "w2"))
    args = moe.MoEMeshArgs(mesh, ("data",), "data" if mesh.shape["data"] > 1
                           else None, "model", weight_mode=mode)
    B, Sq, d = x.shape
    f = w1.shape[-1]
    fsdp = moe._mesh_layout(args, B, Sq, d, f, 4, 2, cf)["fsdp_axis"]
    w_d, w_f = ((P("model", None, fsdp), P("model", fsdp, None))
                if mode == "stationary" else
                (P("model", fsdp, None), P("model", None, fsdp)))
    dp = P(("data",), None, None)

    def body(xb, wr, w1, w3, w2):
        return moe.moe_ffn({"router": wr, "w1": w1, "w3": w3, "w2": w2}, xb,
                           n_experts=4, top_k=2, capacity_factor=cf,
                           mesh_args=args, d_ff=f)
    y, aux = smc.shard_map(body, mesh=mesh,
                           in_specs=(dp, P(None, None), w_d, w_d, w_f),
                           out_specs=(dp, P()))(x, wr, w1, w3, w2)
    return smc.gather_full(y, mesh).numpy(), smc.local(aux).numpy()


def mesh_cases(rank, world, out, inputs):
    ins = np.load(inputs)
    res = {}
    cf = float(ins["cf"])
    # expert-parallel MoE on (2, 2), both weight modes; at data = 1 also
    # against the one-device port
    m22 = M.make_mesh((2, 2), ("data", "model"), "cpu")
    for mode in ("gather", "stationary"):
        res[f"moe22_{mode}_y"], res[f"moe22_{mode}_aux"] = _moe_on(
            m22, mode, ins, cf)
    x = torch.from_numpy(ins["x"])
    one = {k: torch.from_numpy(ins[k]) for k in ("wr", "w1", "w3", "w2")}
    one["router"] = one.pop("wr")
    y1, aux1 = moe.moe_ffn(one, x, n_experts=4, top_k=2, capacity_factor=cf)
    res["moe_one_y"], res["moe_one_aux"] = y1.numpy(), aux1.numpy()
    m14 = M.make_mesh((1, 4), ("data", "model"), "cpu")
    for mode in ("gather", "stationary"):
        res[f"moe14_{mode}_y"], res[f"moe14_{mode}_aux"] = _moe_on(
            m14, mode, ins, cf)
    # compressed_psum over 4 ranks: each rank's block of the global x
    m41 = M.make_mesh((4, 1), ("data", "model"), "cpu")
    cp = smc.shard_map(lambda v: comp.compressed_psum(v, "data"), mesh=m41,
                       in_specs=P("data"), out_specs=P())
    res["cpsum"] = smc.local(cp(torch.from_numpy(ins["cx"]))).numpy()
    # GPipe over 4 stages
    ms = M.make_mesh((4,), ("stage",), "cpu")
    W, xm = torch.from_numpy(ins["pw"]), torch.from_numpy(ins["px"])
    outp = pipeline_apply(lambda p, v: torch.tanh(v @ p), W, xm, mesh=ms)
    res["pipe"] = smc.local(outp).numpy()
    # attention on a mesh: value and gradients against one device
    for name, mm in (("a22", m22), ("a14", m14)):
        for k, v in _sharded_attention(mm).items():
            res[f"{name}_{k}"] = v
    if rank == 0:
        np.savez(os.path.join(out, "mesh_cases.npz"), **res)


def _sharded_attention(mesh):
    """attention_block (granite reduced: H 4, Hkv 2, D 16) on a mesh, heads
    over ``model`` as the plan lays them (kv heads whole where 2 does not
    divide over the axis), batch over ``data``; its output and the
    gradients of x, wq and wk (gathered) and of the one-device block."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    gen = torch.Generator().manual_seed(3)
    ap = attn_mod.init_attn_params(gen, cfg, torch.float32)
    x = torch.randn((4, 32, cfg.d_model), generator=gen)
    cot = torch.randn((4, 32, cfg.d_model), generator=gen)
    pos = torch.arange(32)
    plan = S.make_plan(mesh)
    m = plan.model_axis
    specs = {k: S._divisible(S._param_spec(("layers", "e0", "attn", k),
                                           v.dim() + 1, plan)[1:],
                             v.shape, dict(mesh.shape))
             for k, v in ap.items()}
    ref_ap = {k: v.clone().requires_grad_(True) for k, v in ap.items()}
    ref_x = x.clone().requires_grad_(True)
    ref = attn_mod.attention_block(ref_ap, ref_x, pos, cfg)[0]
    ref_g = torch.autograd.grad((ref * cot).sum(), [ref_x, ref_ap["wq"],
                                                    ref_ap["wk"]])

    def body(ap_l, x_l, cot_l):
        ap_l = {k: v.detach().requires_grad_(True) for k, v in ap_l.items()}
        x_l = x_l.detach().requires_grad_(True)
        full = {k: smc.gather_spec(v, specs[k], (m,)) for k, v in ap_l.items()}
        tp = T.TP(m, m in smc.spec_axes(full["wq"][1]),
                  m in smc.spec_axes(full["wk"][1]))
        y = attn_mod.attention_block({k: v for k, (v, _) in full.items()},
                                     x_l, pos, cfg, tp=tp)[0]
        share = (y * cot_l).sum() / mesh.shape[m]
        g = torch.autograd.grad(share, [x_l, ap_l["wq"], ap_l["wk"]])
        # x is replicated over model: its gradient is the sum of the shares'
        gx = smc.psum(g[0], m)
        gq = smc.psum(g[1], tuple(a for a in mesh.axis_names
                                  if a not in smc.spec_axes(specs["wq"])))
        gk = smc.psum(g[2], tuple(a for a in mesh.axis_names
                                  if a not in smc.spec_axes(specs["wk"])))
        return y.detach(), gx, gq, gk
    dp = P("data", None, None)
    y, gx, gq, gk = smc.shard_map(
        body, mesh=mesh, in_specs=({k: specs[k] for k in ap}, dp, dp),
        out_specs=(dp, dp, specs["wq"], specs["wk"]))(ap, x, cot)
    return {"y": smc.gather_full(y, mesh).numpy(),
            "gx": smc.gather_full(gx, mesh).numpy(),
            "gq": smc.gather_full(gq, mesh).numpy(),
            "gk": smc.gather_full(gk, mesh).numpy(),
            "ref_y": ref.detach().numpy(), "ref_gx": ref_g[0].numpy(),
            "ref_gq": ref_g[1].numpy(), "ref_gk": ref_g[2].numpy()}


# ---------------------------------------------------------------------------
# test_torch_sharded_train
# ---------------------------------------------------------------------------
def train_cases(rank, world, out, ref, cases):
    """Each case: 3 steps of ``train(mesh=...)`` from the JAX package's
    initial params (npz ``<case>.npz``, key prefix ``init``); rank 0
    writes the history, the final params and AdamW state (gathered)."""
    for case in cases:
        name, shape, strategy, mode, gc = case
        cfg = torch_ranks.reduced_config(get_config, name)
        mesh = M.make_mesh(tuple(shape), ("data", "model"), "cpu")
        plan = S.make_plan(mesh, strategy=strategy, moe_weight_mode=mode)
        npz = np.load(os.path.join(ref, f"{name}_init.npz"))
        params = params_from_jax(_np_tree(npz, "init"), "cpu", plan)
        from repro_torch.launch.train import train
        # the plan owns the weight mode; train() builds its plan through
        # make_plan, patched here as the JAX side patches its own
        make_plan = S.make_plan
        S.make_plan = functools.partial(make_plan, moe_weight_mode=mode)
        try:
            p, hist, _ = train(
                cfg, ShapeConfig("t", 32, 4, "train"), n_steps=3, mesh=mesh,
                strategy=strategy, log_every=1, opts=T.ModelOptions(**CHUNKS),
                grad_compression=gc, device="cpu", params=params,
                ckpt_dir=os.path.join(out, f"ck_{_case_key(case)}"),
                ckpt_every=100)
        finally:
            S.make_plan = make_plan
        # the opt state comes back through the (sharded) checkpoint
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(os.path.join(out, f"ck_{_case_key(case)}"))
        like = {"params": p, "opt": adamw.init(p)}
        _, st = mgr.restore(like)
        res = {"loss": np.array([h["loss"] for h in hist]),
               "gnorm": np.array([h["gnorm"] for h in hist])}
        res.update(_flat(_full(p, mesh), "params"))
        res.update(_flat(_full(st["opt"].mu, mesh), "mu"))
        res.update(_flat(_full(st["opt"].nu, mesh), "nu"))
        if rank == 0:
            np.savez(os.path.join(out, f"port_{_case_key(case)}.npz"), **res)


def _case_key(case) -> str:
    name, shape, strategy, mode, gc = case
    return f"{name}_{shape[0]}x{shape[1]}_{strategy}_{mode}_{int(gc)}"


def serve_cases(rank, world, out, ref):
    """granite reduced on (2, 2): the sharded prefill step (4 prompts of
    16) and 4 decode steps over a cache of 32 (``cache_shardings``), and
    the one-device port's steps on the same weights, at the
    configuration's capacity factor and at 4 (no drops); rank 0 writes
    the logits."""
    base = get_config("granite-moe-1b-a400m").reduced()
    npz = np.load(os.path.join(ref, "serve_inputs.npz"))
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    plan = S.make_plan(mesh)
    jp = _np_tree(np.load(os.path.join(ref, "granite-moe-1b-a400m_init.npz")),
                  "init")
    sp = params_from_jax(jp, "cpu", plan)
    p1 = params_from_jax(jp, "cpu")
    opts = T.ModelOptions(**CHUNKS)
    toks = torch.from_numpy(npz["tokens"]).long()
    nxt = torch.from_numpy(npz["next"]).long()
    res = {}
    cf4 = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=4.0))
    for tag, prm, pl, cfg in (("mesh", sp, plan, base),
                              ("one", p1, None, base),
                              ("mesh_cf4", sp, plan, cf4),
                              ("one_cf4", p1, None, cf4)):
        pre = steps.make_prefill_step(cfg, opts, plan=pl)
        dec = steps.make_decode_step(cfg, opts, plan=pl)
        logits, cache = pre(prm, {"tokens": toks})
        full = T.init_cache(cfg, toks.shape[0], 32, device="cpu")
        if pl is not None:
            sh = S.cache_shardings(full, cfg, pl)
            big = S.shard_tree(full, sh)
            for e, c in cache.items():
                for k, v in c.items():
                    smc.local(big[e][k])[:, :, :16] = smc.local(v)
            cache = big
        else:
            for e, c in cache.items():
                for k, v in c.items():
                    full[e][k][:, :, :16] = v
            cache = full
        out_l = [smc.gather_full(logits, mesh).numpy()]
        for i in range(nxt.shape[1]):
            logits, cache = dec(prm, cache, 16 + i, token=nxt[:, i])
            out_l.append(smc.gather_full(logits, mesh).numpy())
        res[tag] = np.stack(out_l)
    if rank == 0:
        np.savez(os.path.join(out, "port_serve.npz"), **res)


# ---------------------------------------------------------------------------
# test_torch_sharded_ckpt
# ---------------------------------------------------------------------------
def ckpt_cases(rank, world, out, ref):
    """Save granite reduced's params and AdamW state on (2, 2), restore
    onto (4, 1) (every rank checks its blocks bitwise against the global
    tensors); rank 0 also restores onto one process (written out for the
    test).  Then a resumed run against an uninterrupted one, bitwise."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train
    cfg = get_config("granite-moe-1b-a400m").reduced()
    gen = torch.Generator().manual_seed(0)
    full = T.init_params(gen, cfg)
    m22 = M.make_mesh((2, 2), ("data", "model"), "cpu")
    m41 = M.make_mesh((4, 1), ("data", "model"), "cpu")
    plan = S.make_plan(m22)
    params = S.shard_tree(full, S.param_shardings(full, cfg, plan))
    state = adamw.init(params)
    for path, t in leaves_with_paths(state.mu):
        smc.local(t).normal_(generator=torch.Generator().manual_seed(
            len(path)))
    d = os.path.join(out, "ck22")
    mgr = CheckpointManager(d)
    mgr.save(7, {"params": params, "opt": state}, block=False)
    mgr.wait()
    want = {"params": full, "opt": tree_map(
        lambda t: smc.gather_full(t, m22), state)}
    # onto (4, 1): DTensor targets laid out on the other mesh
    plan41 = S.make_plan(m41)
    sh41 = S.param_shardings(full, cfg, plan41)
    like = {"params": full, "opt": want["opt"]}
    like41 = {"params": S.shard_tree(full, sh41), "opt": adamw.AdamState(
        step=want["opt"].step, mu=S.shard_tree(want["opt"].mu, sh41),
        nu=S.shard_tree(want["opt"].nu, sh41))}
    step, got = mgr.restore(like41)
    assert step == 7
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        if isinstance(g, smc.DTensor):
            s = smc.spec_of(g)
            w = w[smc.local_slices(w.shape, s, m41)]
            g = smc.local(g)
        assert torch.equal(g, w), path
    if rank == 0:
        _, one = mgr.restore(like)
        np.savez(os.path.join(out, "one.npz"),
                 **_flat(tree_map(lambda t: t.numpy(), one), "got"),
                 **_flat(tree_map(lambda t: t.numpy(), want), "want"))
    # resume after step 2 of 3 against the uninterrupted run
    kw = dict(mesh=m22, log_every=1, opts=T.ModelOptions(**CHUNKS),
              device="cpu")
    shape = ShapeConfig("t", 32, 4, "train")
    p_all, h_all, _ = train(cfg, shape, n_steps=3, **kw)
    rd = os.path.join(out, "resume")
    train(cfg, shape, n_steps=2, ckpt_dir=rd, ckpt_every=2, **kw)
    p_res, h_res, _ = train(cfg, shape, n_steps=3, ckpt_dir=rd,
                            ckpt_every=100, resume=True, **kw)
    assert [h["step"] for h in h_res] == [2]
    assert h_res[0]["loss"] == h_all[2]["loss"], (h_res, h_all)
    for (path, a), (_, b) in zip(leaves_with_paths(p_all),
                                 leaves_with_paths(p_res)):
        assert torch.equal(smc.local(a), smc.local(b)), path
    if rank == 0:
        np.savez(os.path.join(out, "resume.npz"),
                 all=np.array([h["loss"] for h in h_all]),
                 res=np.array([h["loss"] for h in h_res]))


# ---------------------------------------------------------------------------
# test_torch_seqcache
# ---------------------------------------------------------------------------
def seq_config(name: str, window: int):
    """A reduced configuration; ``window`` > 0 replaces its window (a
    ring shorter than the prompt)."""
    cfg = torch_ranks.reduced_config(get_config, name)
    return dataclasses.replace(cfg, window=window) if window else cfg


def seqcache_cases(rank, world, out, ref, cases, prompt, max_len, n_decode):
    """Each case (name, window, mesh shape, kv_seq_axis): the sharded
    prefill of 4 prompts, the cache grown to ``max_len`` slots as the
    one-device ``serve`` grows it and laid out again by
    ``cache_shardings``, then ``n_decode`` sharded decode steps; rank 0
    writes the logits of every step and each rank the k/v layout it
    held."""
    from repro_torch.launch.serve import _grow_cache
    for name, window, shape, kv_axis in cases:
        cfg = seq_config(name, window)
        key = f"{name}_{window}_{shape[0]}x{shape[1]}_{kv_axis}"
        mesh = M.make_mesh(tuple(shape), ("data", "model"), "cpu")
        plan = S.make_plan(mesh)
        npz = np.load(os.path.join(ref, f"{name}_init.npz"))
        params = params_from_jax(_np_tree(npz, "init"), "cpu", plan)
        inputs = np.load(os.path.join(ref, "seq_inputs.npz"))
        toks = torch.from_numpy(inputs["tokens"]).long()
        nxt = torch.from_numpy(inputs["next"]).long()
        opts = T.ModelOptions(**CHUNKS)
        pre = steps.make_prefill_step(cfg, opts, plan=plan,
                                      kv_seq_axis=kv_axis)
        dec = steps.make_decode_step(cfg, opts, plan=plan)
        logits, cache = pre(params, {"tokens": toks})
        whole = _grow_cache(tree_map(lambda t: smc.gather_full(t, mesh),
                                     cache), max_len, prompt)
        cache = S.shard_tree(whole, S.cache_shardings(
            whole, cfg, plan, kv_seq_axis=kv_axis))
        split = [e for e, c in cache.items() if "k" in c
                 and "model" in smc.spec_axes(smc.spec_of(c["k"]))
                 and smc.spec_of(c["k"])[2] is not None]
        outs = [smc.gather_full(logits, mesh).numpy()]
        for i in range(n_decode):
            logits, cache = dec(params, cache, prompt + i, token=nxt[:, i])
            outs.append(smc.gather_full(logits, mesh).numpy())
        if rank == 0:
            np.savez(os.path.join(out, f"port_{key}.npz"),
                     logits=np.stack(outs), split=np.array(len(split)))


# ---------------------------------------------------------------------------
# test_torch_dryrun
# ---------------------------------------------------------------------------
def _collective_log():
    """A dispatch mode logging each collective op of the port
    (``shardmap_compat.COLLECTIVE_OPS``) as (HLO opcode, operand bytes)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = smc.COLLECTIVE_OPS.get(func._schema.name)
            if kind is not None:
                self.calls.append((kind, args[0].numel()
                                   * args[0].element_size()))
            return func(*args, **(kwargs or {}))
    return Log()


def collective_cases(rank, world, out, seq, batch):
    """One eager sharded train step of reduced granite on (2, 2) over
    gloo, every collective logged; rank 0 writes the log."""
    import json
    cfg = get_config("granite-moe-1b-a400m").reduced()
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    plan = S.make_plan(mesh)
    full = T.init_params(torch.Generator().manual_seed(0), cfg)
    params = S.shard_tree(full, S.param_shardings(full, cfg, plan))
    step = steps.make_train_step(cfg, T.ModelOptions(), adamw.OptConfig(),
                                 donate=True, plan=plan)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen)
    data = {"tokens": tokens, "labels": tokens.int()}
    fn, args = step.local_args(params, adamw.init(params), data)
    log = _collective_log()
    with log:
        fn(*args)
    if rank == 0:
        with open(os.path.join(out, "eager_collectives.json"), "w") as f:
            json.dump(log.calls, f)


# c10d's op of each of the port's collective ops on gloo
C10D_KINDS = {"c10d::allreduce_": "all-reduce",
              "c10d::_allgather_base_": "all-gather",
              "c10d::_reduce_scatter_base_": "reduce-scatter"}


def collective_event_cases(rank, world, out):
    """One donated sharded train step of reduced granite on (1, 2) over
    gloo, after a warm one, under torch.profiler: the port's collective
    op events (``chip_smoke.collective_op_events``), c10d's collective
    ops and the dry run's collectives of the same step; rank 0 writes
    them."""
    import json
    import sys
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import dryrun
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    cfg = get_config("granite-moe-1b-a400m").reduced()
    mesh = M.make_mesh((1, world), ("data", "model"), "cpu")
    plan = S.make_plan(mesh, strategy="tp")
    opts = T.ModelOptions(**CHUNKS)
    full = T.init_params(torch.Generator().manual_seed(0), cfg)
    params = S.shard_tree(full, S.param_shardings(full, cfg, plan))
    opt = adamw.init(params)
    step = steps.make_train_step(cfg, opts, adamw.OptConfig(), donate=True,
                                 plan=plan)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen)
    data = {"tokens": tokens, "labels": tokens.int()}
    step(params, opt, data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, data)
    events = prof.events()
    c10d: dict = {}
    for e in events:
        if e.name in C10D_KINDS:
            c10d[C10D_KINDS[e.name]] = c10d.get(C10D_KINDS[e.name], 0) + 1
    rec = dryrun.dry_run(cfg, ShapeConfig("t", 32, 4, "train"), plan,
                         label="granite_1x2", mesh_desc="1x2", opts=opts)
    if rank == 0:
        with open(os.path.join(out, "collective_events.json"), "w") as f:
            json.dump(dict(ops=chip_smoke.collective_op_events(events),
                           c10d=c10d, dry=rec["collectives"]), f)


def profiled_train(rank, world, out):
    """Two donated steps of reduced qwen2 on (1, 2) under the profiler:
    each rank measures itself into ``<out>/prof/rank<R>``."""
    from repro_torch.launch.train import train
    cfg = get_config("qwen2-1.5b").reduced()
    mesh = M.make_mesh((1, world), ("data", "model"), "cpu")
    train(cfg, ShapeConfig("t", 32, 2, "train"), n_steps=2, mesh=mesh,
          profile_dir=os.path.join(out, "prof"), device="cpu",
          opts=T.ModelOptions(**CHUNKS), log_every=1)
